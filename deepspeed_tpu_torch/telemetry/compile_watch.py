"""Program-signature watch (counterpart of
``deepspeed_tpu/telemetry/compile_watch.py``).

In JAX a jitted entry point fed a new shape or dtype silently
recompiles. The port runs eagerly, and on CUDA replays one captured
graph whose static buffers fix the shapes, so the same discipline holds:
one program signature per entry point for the life of a server.
``CompileWatch.wrap`` records each call's signature — the shape, dtype
and device of every tensor or array argument, the value of every other
one — and counts a new signature after the first as a retrace, logged
with the argument that changed. ``record_capture`` counts CUDA graph
captures.
"""

import functools

from deepspeed_tpu_torch.telemetry import metrics as _metrics
from deepspeed_tpu_torch.utils.logging import logger


def _leaves(x, out):
    if isinstance(x, (list, tuple)):
        for y in x:
            _leaves(y, out)
    elif isinstance(x, dict):
        for k in sorted(x):
            _leaves(x[k], out)
    else:
        out.append(x)
    return out


def _leaf_sig(x):
    """(shape, dtype, device) of a tensor or array, else its value (its
    repr when unhashable)."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return ("aval", tuple(shape), str(dtype),
                str(getattr(x, "device", "cpu")))
    try:
        hash(x)
        return ("static", x)
    except TypeError:
        return ("static", repr(x))


def _fmt(sig):
    if sig[0] == "aval":
        _, shape, dtype, device = sig
        return f"{dtype}[{','.join(str(d) for d in shape)}]@{device}"
    return f"static:{sig[1]!r}"


class CompileWatch:
    """Signature and capture counts across any number of wrapped
    entry points."""

    def __init__(self, registry=None, log_fn=None):
        self.registry = registry if registry is not None \
            else _metrics.get_registry()
        self.log_fn = log_fn or logger.warning
        self.compiles = 0
        self.retraces = 0
        self.captures = 0
        self._per_fn = {}

    def signatures(self, name):
        """Distinct signatures seen by the entry point ``name``."""
        return len(self._per_fn.get(name, {}).get("sigs", ()))

    def wrap(self, fn, name=None):
        """Return *fn* with signature tracking."""
        name = name or getattr(fn, "__name__", repr(fn))
        state = self._per_fn.setdefault(name, {"sigs": set(), "last": None})

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            sig = tuple(_leaf_sig(x) for x in _leaves((args, kwargs), []))
            if sig not in state["sigs"]:
                first = not state["sigs"]
                state["sigs"].add(sig)
                self.compiles += 1
                self.registry.counter(
                    "program_signatures_total",
                    "distinct argument signatures seen by wrapped entry "
                    "points", labels={"fn": name}).inc()
                if not first:
                    self.retraces += 1
                    self.registry.counter(
                        "program_retraces_total",
                        "NEW signatures after the first (retraces)",
                        labels={"fn": name}).inc()
                    self.log_fn(self._report(name, state["last"], sig))
                state["last"] = sig
            return fn(*args, **kwargs)

        return wrapped

    def record_capture(self, name):
        """Count one CUDA graph capture of the program ``name``."""
        self.captures += 1
        self.registry.counter("cuda_graph_captures_total",
                              "CUDA graph captures",
                              labels={"fn": name}).inc()

    def _report(self, name, prev, cur):
        """One line naming the first argument whose signature changed."""
        head = f"[compile-watch] retrace #{self.retraces} of {name!r}"
        tail = f" ({len(self._per_fn[name]['sigs'])} signatures seen)"
        if prev is None or len(prev) != len(cur):
            return head + ": call structure changed" + tail
        diffs = [(i, a, b) for i, (a, b) in enumerate(zip(prev, cur))
                 if a != b]
        if not diffs:
            return head + tail
        i, a, b = diffs[0]
        more = f" (+{len(diffs) - 1} more)" if len(diffs) > 1 else ""
        return (head + f": arg #{i} changed {_fmt(a)} -> {_fmt(b)}{more}"
                + tail)
