"""ZeRO-3 parameter offload: the parameters live on the host (RAM or
NVMe) and stream to the card one layer at a time (counterpart of
``deepspeed_tpu/runtime/zero/param_offload.py``; the reference's
``zero.Init(remote_device=cpu|nvme)``, partition_parameters.py:701, its
fetch/release coordinator, zero/stage3.py:172, and the partitioned
parameter swapper, swap_tensor/partitioned_param_swapper.py:36).

The model is a sequence of layers (``models/gpt2.gpt2_offload_layers``):
``layers[:-1]`` map ``x -> x``, ``layers[-1]`` maps ``(x, batch) ->``
the scalar loss. The whole parameter set never exists on the card:

* **Masters are born on the host.** Each layer is initialised on the CPU
  from a generator of its own, seeded by (seed, layer index), and its
  fp32 tensors become the masters of :class:`HostParamStore`:
  C-contiguous, pinned when the engine runs on a card (the source of the
  asynchronous copies), or in files of the NVMe swap folder.
* **One module a distinct layer.** The engine keeps one skeleton of each
  layer object it is given (a 48-block stack passes one block module 48
  times: one skeleton, not 48) on the ``meta`` device, and calls it with
  the fetched tensors through ``torch.func.functional_call``, the
  counterpart of flax's ``mod.apply({"params": p}, x)``.
* **The forward sweep** fetches layer i, prefetches layer i + 1 (an
  asynchronous host-to-card copy on a side stream: the compute stream
  waits on its event, and a tensor made there is ``record_stream``-ed to
  the compute stream before ``release`` drops it), computes under
  ``no_grad`` and releases. The card holds at most two layers.
* **The loss head** takes the loss and its gradients with respect to
  (params, input).
* **The backward sweep** fetches each layer again and recomputes its
  forward for the VJP: remat at layer granularity, no autograd graph
  spans two layers. Each layer's gradients are computed in the compute
  dtype, cast to fp32 on the card (JAX casts on the host, ``_to_host``;
  the values are the same) and copied on a second side stream into
  pinned fp32 host buffers.
* **The host step.** CPU-Adam (``ops/adam/cpu_adam``, ``csrc/cpu_adam
  .cpp``) updates the masters one layer at a time, after waiting for that
  layer's gradient copies; NVMe masters visit RAM one layer at a time.
  There is no numpy fallback: a library that does not build raises
  (``op_builder.load_host``).

Link bytes of a step: the fp32 masters cross to the card twice (the
sweep and the recompute) and are cast to the compute dtype there; the
fp32 gradients cross back once.

A checkpoint is the JAX engine's file: a pickle of lists of numpy
arrays, one list a layer (``params``, ``exp_avg``, ``exp_avg_sq``), in
``mp_rank_00_model_states.pt``, and ``latest``. For the layer kinds of
``bridge.LAYOUTS`` the leaves are in JAX's order and flax's layout, so a
tag of either engine loads into the other (``bridge.layer_to_jax``).
"""

import copy
import inspect
import itertools
import os
import pickle
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.func import functional_call

from deepspeed_tpu_torch import bridge
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops._platform import resolve_device
from deepspeed_tpu_torch.ops.adam.cpu_adam import _ids, _ptr
from deepspeed_tpu_torch.runtime.constants import (LATEST_FILE,
                                                   MODEL_FILE_SUFFIX)
from deepspeed_tpu_torch.runtime.engine import _to_device
from deepspeed_tpu_torch.utils.logging import log_dist

_store_ids = itertools.count()
_GLOBAL_RNG = threading.Lock()


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class HostParamStore:
    """Per-layer fp32 masters on the host, optionally backed by NVMe files,
    with the card's live-bytes accounting (the swap half of the
    reference's partitioned_param_swapper.py:36). ``device``: where
    :meth:`fetch` puts a layer; None means CUDA and raises without a card
    (a CUDA device copies from pinned masters on a side stream)."""

    def __init__(self, nvme_path: Optional[str] = None,
                 swap_folder: Optional[str] = None, device=None):
        # swap keys are namespaced per store, so several stores may share
        # one caller-supplied folder
        self._key_prefix = f"st{next(_store_ids)}_{os.getpid()}_"
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._ram: List[Optional[List[torch.Tensor]]] = []
        self.names: List[List[str]] = []
        self._meta: List[List[tuple]] = []
        self.swapper = None
        self._swap_folder = None
        self._owns_folder = False
        if nvme_path is not None:
            from deepspeed_tpu_torch.runtime.swap_tensor.swapper import \
                AsyncTensorSwapper
            self._owns_folder = swap_folder is None
            self._swap_folder = swap_folder or os.path.join(
                nvme_path, f"ds_param_offload_{os.getpid()}_"
                           f"{self._key_prefix}")
            self.swapper = AsyncTensorSwapper(self._swap_folder)
        # the card's residency (the tests and chip_smoke assert peak <<
        # total): the fetched layers in the compute dtype
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.total_param_bytes = 0
        self.h2d_bytes = 0           # host bytes fetched, cumulative
        self._dev = {}
        self._dev_bytes = {}
        self._ready = {}
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)

    def _key(self, i: int, j: int) -> str:
        return f"{self._key_prefix}L{i}_p{j}"

    # ------------------------------------------------------------ host side
    def add_layer(self, params) -> int:
        """Take one layer's parameters (``{name: tensor}``) as fp32 host
        masters: C-contiguous and writable (CPU-Adam's contract: it walks
        them by ``data_ptr()``), pinned when fetching to a card."""
        names = list(params)
        host = []
        for n in names:
            t = params[n].detach()
            h = torch.empty(tuple(t.shape), dtype=torch.float32,
                            pin_memory=self._cuda and self.swapper is None)
            h.copy_(t)
            host.append(h)
        self.total_param_bytes += _nbytes(host)
        i = len(self.names)
        self.names.append(names)
        self._meta.append([tuple(h.shape) for h in host])
        if self.swapper is not None:
            for j, h in enumerate(host):
                self.swapper.swap_out(self._key(i, j), h)
            self.swapper.synchronize()
            self._ram.append(None)
        else:
            self._ram.append(host)
        return i

    def host_leaves(self, i: int) -> List[torch.Tensor]:
        """Layer i's masters in RAM (read back from NVMe when backed)."""
        if self._ram[i] is not None:
            return self._ram[i]
        # every leaf's read in flight at once, then wait for each
        reads = [self.swapper.swap_in_async(self._key(i, j))
                 for j in range(len(self.names[i]))]
        for buf, req in reads:
            self.swapper.wait(req, buf.numel() * buf.element_size())
        return [buf for buf, _ in reads]

    def write_back(self, i: int, leaves: List[torch.Tensor]):
        """Persist updated masters (NVMe; RAM masters update in place)."""
        if self._ram[i] is not None:
            return
        for j, h in enumerate(leaves):
            self.swapper.swap_out(self._key(i, j), h)
        self.swapper.synchronize()

    def close(self):
        """Delete this store's NVMe swap files (the masters are the whole
        model: leaking them across runs fills the disk). A caller-supplied
        folder may be shared, so only this store's own files go."""
        if self.swapper is None or self._swap_folder is None:
            return
        self.swapper.synchronize()
        if self._owns_folder:
            shutil.rmtree(self._swap_folder, ignore_errors=True)
        else:
            for i, names in enumerate(self.names):
                for j in range(len(names)):
                    try:
                        os.remove(self.swapper._path(self._key(i, j)))
                    except OSError:
                        pass
        self.swapper = None

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass

    # ---------------------------------------------------------- card side
    def prefetch(self, i: int, dtype):
        """Start putting layer i on the device in ``dtype`` (the
        reference's fetch_sub_module): on a card, asynchronous copies on
        the side stream, then the cast there; nothing if it is there."""
        if i in self._dev:
            return
        src = self.host_leaves(i)
        self.h2d_bytes += _nbytes(src)
        if self._cuda:
            stream = self._copy_stream
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                leaves = [h.to(self.device, non_blocking=True).to(dtype)
                          for h in src]
                ready = torch.cuda.Event()
                ready.record(stream)
            self._ready[i] = ready
        else:
            leaves = [h.to(dtype, copy=True) for h in src]
        self._dev[i] = dict(zip(self.names[i], leaves))
        self._dev_bytes[i] = _nbytes(leaves)
        self.live_bytes += self._dev_bytes[i]
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def fetch(self, i: int, dtype):
        """Layer i's tensors on the device, ready for the current stream
        (which waits on their copy's event: no host sync)."""
        self.prefetch(i, dtype)
        ready = self._ready.pop(i, None)
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            for t in self._dev[i].values():
                t.record_stream(current)
        return self._dev[i]

    def release(self, i: int):
        """Drop the device copy (release_sub_module)."""
        if i in self._dev:
            self.live_bytes -= self._dev_bytes.pop(i)
            del self._dev[i]
            self._ready.pop(i, None)


class _HostAdam:
    """One Adam leaf update on host fp32 tensors through the AVX CPU-Adam
    library (``csrc/cpu_adam.cpp``, built by ``op_builder.load_host``;
    a failed build raises). Per leaf, so that NVMe masters stream through
    RAM one layer at a time."""

    def __init__(self, betas, eps, weight_decay, adamw_mode):
        self.lib = op_builder.load_host("cpu_adam")
        self.opt_id = next(_ids)
        self.lib.ds_adam_create(self.opt_id, betas[0], betas[1], eps,
                                weight_decay, 1 if adamw_mode else 0)

    def step_leaf(self, step_no, lr, p, g, m, v):
        rc = self.lib.ds_adam_step(self.opt_id, step_no, lr, _ptr(p),
                                   _ptr(g), _ptr(m), _ptr(v), p.numel())
        if rc != 0:
            raise RuntimeError(f"ds_adam_step failed ({rc})")

    def __del__(self):
        try:
            self.lib.ds_adam_destroy(self.opt_id)
        except Exception:
            pass


def _layer_seed(seed, i):
    """The generator seed of layer ``i``: a hash of (seed, i)."""
    return int(np.random.SeedSequence([int(seed), int(i)])
               .generate_state(1, np.uint64)[0] >> 1)


def _init_layer(module, seed):
    """A CPU fp32 copy of ``module`` with its parameters drawn from
    ``seed``: the module's ``reset_parameters(generator)`` when it takes
    one (the GPT-2 layers' init; layers draw in parallel threads, each
    from its own generator), else each submodule's ``reset_parameters()``
    under a forked, seeded CPU generator (one layer at a time: the
    generator is global)."""
    layer = copy.deepcopy(module).to_empty(device="cpu").float()
    gen = torch.Generator().manual_seed(seed)
    fn = getattr(layer, "reset_parameters", None)
    if fn is not None and "generator" in inspect.signature(fn).parameters:
        with torch.no_grad():
            fn(generator=gen)
        return layer
    with _GLOBAL_RNG, torch.random.fork_rng(devices=[]), torch.no_grad():
        torch.manual_seed(seed)
        for sub in layer.modules():
            reset = getattr(sub, "reset_parameters", None)
            if callable(reset):
                reset()
    return layer


class Zero3OffloadEngine:
    """Train a layered model whose parameters exceed the card's memory.

    ``layers[:-1]`` map ``x -> x``; ``layers[-1]`` maps ``(x, batch) ->``
    the scalar loss. ``input_fn`` takes the first layer's input from a
    batch (default ``batch[0]``). ``device=None`` means CUDA (raises
    without a card); ``compute_dtype`` is the dtype the layers run in
    (fp32 masters on the host either way). ``sample_batch`` is accepted
    for the JAX signature (PyTorch layers know their shapes)."""

    def __init__(self, layers: Sequence, sample_batch=None, lr=1e-3,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 adamw_mode=True, compute_dtype=torch.float32,
                 input_fn: Callable = None, nvme_path: Optional[str] = None,
                 seed: int = 0, device=None):
        self.layers = list(layers)
        if len(self.layers) < 2:
            raise AssertionError("need at least one body layer + loss head")
        self.device = resolve_device(device)
        self.input_fn = input_fn or (lambda b: b[0])
        self.compute_dtype = compute_dtype
        self.lr = lr
        self.store = HostParamStore(nvme_path=nvme_path, device=self.device)
        self._adam = _HostAdam(betas, eps, weight_decay, adamw_mode)
        self.global_steps = 0
        self.last_host_ms = 0.0      # the last step's CPU-Adam (and swap) ms
        self.d2h_bytes = 0           # fp32 gradient bytes sent, cumulative

        # one meta skeleton a distinct layer object (JAX dedupes its jitted
        # programs by module equality, param_offload.py:205-231)
        skeletons = {}
        self._mods = []
        for m in self.layers:
            if not isinstance(m, torch.nn.Module):
                raise TypeError(f"a layer must be a torch.nn.Module, got "
                                f"{type(m).__name__}")
            if next(m.buffers(), None) is not None:
                raise ValueError(f"{type(m).__name__} holds buffers; the "
                                 f"layered engine streams parameters only")
            if id(m) not in skeletons:
                skeletons[id(m)] = copy.deepcopy(m).to("meta")
            self._mods.append(skeletons[id(m)])
        # zero.Init: each layer born on the host, never whole on the card;
        # drawn by a few threads at a time (a window of layers in flight),
        # taken into the store in order
        workers = max(1, min(8, os.cpu_count() or 1))
        with ThreadPoolExecutor(workers) as pool:
            for start in range(0, len(self.layers), workers):
                for layer in pool.map(
                        lambda i: _init_layer(self.layers[i],
                                              _layer_seed(seed, i)),
                        range(start, min(start + workers,
                                         len(self.layers)))):
                    self.store.add_layer(dict(layer.named_parameters()))
                    del layer
        self._m = [[torch.zeros_like(h) for h in self.store.host_leaves(i)]
                   for i in range(len(self.layers))]
        self._v = [[torch.zeros_like(h) for h in self.store.host_leaves(i)]
                   for i in range(len(self.layers))]
        cuda = self.device.type == "cuda"
        # pinned fp32 buffers the gradient copies land in, one set a layer
        self._host_grads = [
            [torch.empty(shape, dtype=torch.float32, pin_memory=True)
             for shape in meta] if cuda else None
            for meta in self.store._meta]
        self._grad_events = [None] * len(self.layers)
        self._d2h_stream = torch.cuda.Stream(self.device) if cuda else None
        log_dist(f"Zero3OffloadEngine: {len(self.layers)} layers, "
                 f"{len(skeletons)} distinct, "
                 f"{self.store.total_param_bytes / 2**20:.1f} MiB params "
                 f"host-resident ({'nvme' if nvme_path else 'cpu'})",
                 ranks=[0])

    # ---------------------------------------------------------------- train
    def _param_grads(self, mod, params, args, ct, xin):
        """Gradients of ``mod(params, *args)`` against ``ct`` (None: the
        output is the scalar loss) with respect to the parameters and the
        floating input ``xin`` (or None). Returns (output, [param grads
        in the layer's order], input grad)."""
        leaves = {k: t.requires_grad_() for k, t in params.items()}
        with torch.enable_grad():
            out = functional_call(mod, leaves, args)
        wrt = list(leaves.values()) + ([xin] if xin is not None else [])
        grads = torch.autograd.grad(out, wrt, ct, allow_unused=True)
        p_grads = [torch.zeros_like(t) if g is None else g
                   for t, g in zip(leaves.values(), grads)]
        return out, p_grads, (grads[-1] if xin is not None else None)

    def _grads_to_host(self, i, grads):
        """Layer i's gradients as fp32 host tensors: on a card cast there
        and copied into the pinned buffers on the second side stream (its
        event is waited for before CPU-Adam reads them)."""
        self.d2h_bytes += 4 * sum(g.numel() for g in grads)
        if self._d2h_stream is None:
            self._host_grads[i] = [
                g.detach().to(torch.float32).contiguous() for g in grads]
            return
        g32 = [g.detach().to(torch.float32) for g in grads]
        stream = self._d2h_stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for buf, g in zip(self._host_grads[i], g32):
                buf.copy_(g, non_blocking=True)
                g.record_stream(stream)
            done = torch.cuda.Event()
            done.record(stream)
        self._grad_events[i] = done

    def train_batch(self, batch=None):
        """One step over ``batch``; returns the loss, a device fp32
        scalar."""
        L = len(self.layers)
        dt = self.compute_dtype
        st = self.store
        batch = _to_device(batch, self.device)
        x = self.input_fn(batch)
        if x.is_floating_point():        # token ids stay integer
            x = x.to(dt)

        # forward sweep: fetch i, prefetch i + 1, compute, release
        acts = [x]
        with torch.no_grad():
            for i in range(L - 1):
                p = st.fetch(i, dt)
                st.prefetch(i + 1, dt)
                x = functional_call(self._mods[i], p, (x,))
                acts.append(x)
                st.release(i)

        # the loss head: value and gradients with respect to (params, x)
        p = st.fetch(L - 1, dt)
        st.prefetch(L - 2, dt)
        xin = acts[-1].detach().requires_grad_()
        loss, g_head, ct = self._param_grads(self._mods[-1], p,
                                             (xin, batch), None, xin)
        self._grads_to_host(L - 1, g_head)
        st.release(L - 1)

        # backward sweep: fetch again, recompute for the VJP, stream the
        # gradients to the host
        for i in reversed(range(L - 1)):
            p = st.fetch(i, dt)
            if i >= 1:
                st.prefetch(i - 1, dt)
            x_i = acts[i]
            xin = (x_i.detach().requires_grad_() if x_i.is_floating_point()
                   else None)
            _, g_p, ct = self._param_grads(self._mods[i], p,
                                           (x_i if xin is None else xin,),
                                           ct, xin)
            acts[i + 1] = None
            self._grads_to_host(i, g_p)
            st.release(i)

        self._step()
        self.global_steps += 1
        return loss.detach().float()

    def _step(self):
        """The host Adam step, one layer at a time (NVMe masters visit RAM
        only for their own update, the reference's pipelined optimizer
        swapper's access pattern)."""
        step_no = self.global_steps + 1
        t0 = time.perf_counter()
        for i in range(len(self.layers)):
            if self._grad_events[i] is not None:
                self._grad_events[i].synchronize()
                self._grad_events[i] = None
            masters = self.store.host_leaves(i)
            for p, g, m, v in zip(masters, self._host_grads[i], self._m[i],
                                  self._v[i]):
                self._adam.step_leaf(step_no, self.lr, p, g, m, v)
            self.store.write_back(i, masters)
            if self._d2h_stream is None:
                self._host_grads[i] = None
        self.last_host_ms = (time.perf_counter() - t0) * 1e3

    # ------------------------------------------------------------ checkpoint
    def _tables(self):
        return [bridge.layout_of(names) for names in self.store.names]

    def state_dict(self):
        """``{"params", "exp_avg", "exp_avg_sq": [[ndarray, ...] a layer],
        "step"}``: copies, each layer's leaves in JAX's order and flax's
        layout for a layer kind of ``bridge.LAYOUTS``."""
        tables, names = self._tables(), self.store.names
        out = {"step": self.global_steps}
        for key, lists in (("params", [self.store.host_leaves(i) for i in
                                       range(len(self.layers))]),
                           ("exp_avg", self._m), ("exp_avg_sq", self._v)):
            # C-ordered copies: the JAX engine hands loaded leaves to
            # CPU-Adam as they are (its _ptr wants C-contiguous arrays)
            out[key] = [[np.array(a, np.float32, order="C")
                         for a in bridge.layer_to_jax(
                             t, n, [x.numpy() for x in xs])]
                        for t, n, xs in zip(tables, names, lists)]
        return out

    def load_state_dict(self, sd):
        """Load :meth:`state_dict`'s form, written by this engine or by the
        JAX package's ``Zero3OffloadEngine``."""
        tables, names = self._tables(), self.store.names
        if len(sd["params"]) != len(self.layers):
            raise ValueError(f"the state holds {len(sd['params'])} layers, "
                             f"this engine {len(self.layers)}")
        conv = {key: [bridge.layer_from_jax(t, n, shapes, leaves)
                      for t, n, shapes, leaves in zip(
                          tables, names, self.store._meta, sd[key])]
                for key in ("params", "exp_avg", "exp_avg_sq")}
        with torch.no_grad():
            for i, leaves in enumerate(conv["params"]):
                masters = self.store.host_leaves(i)
                for dst, src in zip(masters, leaves):
                    dst.copy_(torch.from_numpy(np.ascontiguousarray(
                        src, dtype=np.float32)))
                self.store.write_back(i, masters)
        for key, out in (("exp_avg", "_m"), ("exp_avg_sq", "_v")):
            setattr(self, out, [[torch.from_numpy(np.array(
                a, dtype=np.float32, order="C")) for a in layer]
                for layer in conv[key]])
        self.global_steps = int(sd["step"])

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """The JAX engine's file layout: one model-states pickle holding
        the layered masters and moments, and the ``latest`` tag."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        tag_dir = os.path.join(save_dir, str(tag))
        os.makedirs(tag_dir, exist_ok=True)
        sd = self.state_dict()
        sd["client_state"] = client_state or {}
        with open(os.path.join(tag_dir, f"mp_rank_00{MODEL_FILE_SUFFIX}"),
                  "wb") as f:
            pickle.dump(sd, f, protocol=pickle.HIGHEST_PROTOCOL)
        if save_latest:
            with open(os.path.join(save_dir, LATEST_FILE), "w") as f:
                f.write(str(tag))
        return True

    def load_checkpoint(self, load_dir, tag=None):
        """Load a tag (``latest`` when ``tag`` is None); without ``latest``
        the run starts from scratch: ``(None, {})``, as in JAX."""
        if tag is None:
            latest = os.path.join(load_dir, LATEST_FILE)
            if not os.path.exists(latest):
                log_dist(f"no '{LATEST_FILE}' file under {load_dir}; "
                         "starting from scratch", ranks=[0])
                return None, {}
            with open(latest) as f:
                tag = f.read().strip()
        path = os.path.join(load_dir, str(tag),
                            f"mp_rank_00{MODEL_FILE_SUFFIX}")
        with open(path, "rb") as f:
            sd = pickle.load(f)
        client_state = sd.pop("client_state", {})
        self.load_state_dict(sd)
        return path, client_state

    def close(self):
        """Remove this engine's NVMe swap files."""
        self.store.close()
