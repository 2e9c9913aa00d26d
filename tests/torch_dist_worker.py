"""Rank bodies of the port's multi-process tests: ``torch.distributed``
over gloo on the CPU, one process a rank, started with
``torch.multiprocessing`` from a fork server.

This module imports neither ``jax`` nor ``deepspeed_tpu``, so a spawned
rank never loads JAX (``tests/test_torch_package.py`` holds it to that).
The test process computes the JAX references itself and hands the ranks
their inputs through a pickle; :func:`run` spawns the ranks, which
rendezvous through a file (``init_method="file://..."``, no TCP port, so
the suite's xdist workers cannot collide), run a list of cases each, and
pickle one result a rank back.

Run by hand::

    from tests import torch_dist_worker as w
    w.run("engine", 2, tmp_dir, [case, ...])   # -> [results of rank 0, 1]
"""

import os
import pickle
import sys

import numpy as np
import torch

SPAWN_TIMEOUT_S = 600


# ---------------------------------------------------------------- spawning
def _entry(rank, world, root, kind):
    torch.set_num_threads(1)
    import deepspeed_tpu_torch
    deepspeed_tpu_torch.init_distributed(
        dist_backend="gloo", init_method="file://" + os.path.join(
            root, "rendezvous"), world_size=world, rank=rank, verbose=False)
    try:
        with open(os.path.join(root, "cases.pkl"), "rb") as f:
            cases = pickle.load(f)
        out = []
        for case in cases:
            # a case's environment (DS_AIO_DISABLE_KERNEL, read at each
            # transfer) holds for that case only
            saved = {k: os.environ.get(k) for k in case.get("env", {})}
            os.environ.update(case.get("env", {}))
            try:
                out.append(KINDS[case.get("kind", kind)](rank, world, case,
                                                         root))
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "flax",
                                               "deepspeed_tpu"))
        with open(os.path.join(root, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump({"cases": out, "jax_modules": loaded}, f)
    finally:
        torch.distributed.destroy_process_group()


def run(kind, world, root, cases):
    """Run ``cases`` (a list of dicts for ``KINDS[kind]``, or for
    ``KINDS[case["kind"]]`` where a case names its own) on ``world`` gloo
    ranks; returns one ``{"cases": [...], "jax_modules": [...]}`` a rank.
    ``root`` is a fresh directory."""
    import torch.multiprocessing as mp
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    # ranks fork from a server process that imported torch and the port
    # once (it never imports JAX), not from the test process: a rank
    # starts in ~0.1 s instead of the ~4 s of a spawned interpreter
    mp.set_forkserver_preload(["deepspeed_tpu_torch", __name__])
    ctx = mp.start_processes(_entry, args=(world, root, kind), nprocs=world,
                             join=False, start_method="forkserver")
    import time
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{kind} ranks did not finish in "
                               f"{SPAWN_TIMEOUT_S} s")
    out = []
    for r in range(world):
        with open(os.path.join(root, f"result_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------- models
def make_model(case, seed=0):
    from deepspeed_tpu_torch.models import bert, gpt2, simple
    kind, cfg = case["model"], case.get("model_cfg", {})
    if kind == "gpt2":
        import dataclasses
        return gpt2.GPT2LMHeadModel(
            dataclasses.replace(gpt2.PRESETS["tiny"], **cfg), device="cpu",
            seed=seed)
    if kind == "bert":
        torch.manual_seed(seed)
        return bert.BertForPreTraining(bert.BertConfig(**cfg), device="cpu")
    if kind == "embedding":
        return simple.EmbeddingModel(cfg["vocab"], cfg["dim"], device="cpu",
                                     seed=seed)
    raise ValueError(kind)


def rank_rows(batch, rank, world, gas, micro):
    """This rank's rows of micro-batch ``micro`` of a global batch: the
    global batch splits into ``gas`` micro-batches and each of those into
    ``world`` equal runs of rows, rank r the r-th (as a global array is
    sharded over the data axis)."""
    def cut(x):
        x = np.asarray(x)
        m = x.shape[0] // (gas * world)
        start = micro * m * world + rank * m
        return x[start:start + m]
    if isinstance(batch, dict):
        return {k: cut(v) for k, v in batch.items()}
    return type(batch)(cut(v) for v in batch)


def _state_numel(state):
    """The optimizer state's elements on the card (none under offload)."""
    n = 0
    if state is None:
        return n
    for field in state._fields:
        val = getattr(state, field)
        if isinstance(val, dict):
            n += sum(t.numel() for t in val.values())
        elif isinstance(val, torch.Tensor):
            n += val.numel()
    return n


def _engine(case, seed=0):
    """An engine for ``case`` on this rank: the groups at the case's
    ``ep_size`` (default 1) first, as the MoE layers read them when
    built."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.utils import groups
    groups.destroy()
    groups.initialize(ep_size=case.get("ep_size", 1))
    model = make_model(case, seed)
    kw = {}
    if case.get("client"):
        from deepspeed_tpu_torch.runtime import optim
        kw["optimizer"] = {"sgd": lambda: optim.sgd(momentum=0.9),
                           "lamb": lambda: optim.lamb(weight_decay=0.01)}[
                               case["client"]]()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=case["config"],
        model_parameters=case.get("init"), device="cpu", **kw)
    return engine


def _train(engine, batches, rank, world, manual_allreduce=False,
           no_allreduce=False):
    """``train_batch`` on this rank's rows of each global batch; with
    ``manual_allreduce`` the loop ``forward`` /
    ``backward(allreduce_gradients=False)`` / ``allreduce_gradients()`` /
    ``step()`` instead (gas 1), with ``no_allreduce`` the same loop
    without ``allreduce_gradients()`` (the rank's own loss)."""
    gas = engine.gradient_accumulation_steps()
    losses = []
    for b in batches:
        if manual_allreduce or no_allreduce:
            loss = engine.forward(rank_rows(b, rank, world, 1, 0))
            engine.backward(loss, allreduce_gradients=False)
            if manual_allreduce:
                engine.allreduce_gradients()
                loss = engine._mean_over_ranks(loss.detach())
            engine.step()
            losses.append(float(loss))
            continue
        it = iter(rank_rows(b, rank, world, gas, i) for i in range(gas))
        losses.append(float(engine.train_batch(data_iter=it)))
    return losses


def _params(engine):
    """The whole masters (gathered from every rank's slices at stage 3: a
    collective, every rank calls it)."""
    from deepspeed_tpu_torch import zero
    with zero.GatheredParameters(dict(engine.params)) as whole:
        return {k: p.numpy() for k, p in whole.items()}


# ---------------------------------------------------------------- cases
def engine_case(rank, world, case, root):
    """Train ``case["batches"]`` (global batches); losses, the masters,
    counters and the optimizer state's element count."""
    engine = _engine(case)
    losses = _train(engine, case["batches"], rank, world,
                    case.get("manual_allreduce", False),
                    case.get("no_allreduce", False))
    out = {"losses": losses, "params": _params(engine),
           "skipped": engine.skipped_steps,
           "loss_scale": float(engine.loss_scale),
           "global_samples": engine.global_samples,
           "grad_norm": engine.get_global_grad_norm(),
           "last_norm": (None if engine.global_grad_norm is None
                         else float(engine.global_grad_norm)),
           "state_numel": _state_numel(engine.opt_state),
           "masters_numel": sum(p.numel() for p in engine.params.values()),
           "micro_batch": engine.config.train_micro_batch_size_per_gpu}
    if case.get("eval"):
        out["eval"] = float(engine.eval_batch(rank_rows(
            case["batches"][0], rank, world, 1, 0)))
    return out


def dropout_case(rank, world, case, root):
    """The mask one dropout site draws under the key of an engine at
    ``micro_steps`` ``case["micro_step"]``: the same input on every
    rank."""
    from deepspeed_tpu_torch.runtime import dropout
    engine = _engine(dict(model="gpt2", config={
        "train_batch_size": world, "optimizer": {"type": "SGD", "params": {
            "lr": 0.1}}}), seed=0)
    engine._seed, engine.micro_steps = case["seed"], case["micro_step"]
    x = torch.ones(64, 64)
    with dropout.key_scope(engine._dropout_key()):
        return dropout.dropout(x, case["p"], site=0).numpy()


def refusal_case(rank, world, case, root):
    """The error an ``initialize`` raises at this world size, as text."""
    try:
        _engine(case)
    except NotImplementedError as e:
        return f"NotImplementedError: {e}"
    return "no error"


def checkpoint_case(rank, world, case, root):
    """Checkpoints under ``case["dir"]``, in this order: ``load`` a tag
    (``load_tag``, or ``latest``); train ``batches`` (global); ``save``
    tag ``tag`` (``rank_tags``: each rank its own tag name; ``rank_steps``:
    each rank its own ``global_steps``); train ``after``. Returns the
    losses, the masters at the save and at the end, the tag's files, the
    error a save raised and the warnings the engine logged."""
    import logging
    from deepspeed_tpu_torch.utils.logging import logger
    engine = _engine(case, seed=case.get("seed", 0))
    warnings = []
    handler = logging.Handler(level=logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    logger.addHandler(handler)
    out = {}
    try:
        if case.get("load"):
            path, client = engine.load_checkpoint(case["dir"],
                                                  tag=case.get("load_tag"))
            out.update(loaded_from=path, client_state=client,
                       global_steps=engine.global_steps,
                       global_samples=engine.global_samples,
                       state_numel=_state_numel(engine.opt_state))
        out["losses"] = _train(engine, case.get("batches", []), rank, world)
        if case.get("save"):
            tag = case["tag"]
            if case.get("rank_tags"):
                tag = f"{tag}_rank{rank}"
            if case.get("rank_steps"):
                engine.global_steps += rank
            out["params_at_save"] = _params(engine)
            try:
                engine.save_checkpoint(case["dir"], tag=tag,
                                       client_state={"rank_said": rank})
                out["error"] = None
            except RuntimeError as e:
                out["error"] = str(e)
            if case.get("rank_steps"):
                engine.global_steps -= rank
            engine.close()     # an async persist drains here
            torch.distributed.barrier()
            tag_dir = os.path.join(case["dir"], tag)
            out["files"] = (sorted(os.listdir(tag_dir))
                            if os.path.isdir(tag_dir) else [])
        out["after"] = _train(engine, case.get("after", []), rank, world)
        out["params"] = _params(engine)
        engine.close()
    finally:
        logger.removeHandler(handler)
    out["warnings"] = warnings
    return out


def ring_case(rank, world, case, root):
    """Ring or Ulysses attention on this rank's sequence chunk of the
    global q, k, v (and output cotangent): the output chunk and the
    chunks' gradients."""
    from deepspeed_tpu_torch.ops.transformer import ring
    fn = {"ring": ring.ring_attention,
          "ulysses": ring.ulysses_attention}[case["fn"]]
    S = case["q"].shape[2]
    c = S // world
    q, k, v, do = (torch.from_numpy(np.ascontiguousarray(
        case[n][:, :, rank * c:(rank + 1) * c])).requires_grad_(n != "do")
        for n in ("q", "k", "v", "do"))
    try:
        out = fn(q, k, v, causal=case["causal"], sm_scale=case.get("scale"))
    except ValueError as e:
        return {"error": str(e)}
    grads = torch.autograd.grad(out, (q, k, v), do)
    return {"out": out.detach().numpy(),
            "grads": [g.numpy() for g in grads]}


def groups_case(rank, world, case, root):
    """The groups at ``case["ep_size"]``: sizes, ranks and the global
    ranks of the expert-parallel and expert-data groups."""
    from deepspeed_tpu_torch.utils import groups
    groups.destroy()
    groups.initialize(ep_size=case["ep_size"])

    def ranks(g):
        return (None if g is None
                else torch.distributed.get_process_group_ranks(g))
    return {"ep": groups.get_expert_parallel_world_size(),
            "ep_rank": groups.get_expert_parallel_rank(),
            "edp": groups.get_expert_data_parallel_world_size(),
            "edp_rank": groups.get_expert_data_parallel_rank(),
            "ep_ranks": ranks(groups.get_expert_parallel_group()),
            "edp_ranks": ranks(groups.get_expert_data_parallel_group())}


def all_to_all_case(rank, world, case, root):
    """``comm.all_to_all`` over the expert-parallel group (ep = world) of
    x = [[10·rank], [10·rank + 1]] (3 columns), and x's gradient under a
    cotangent of rank + 1."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.utils import groups
    groups.destroy()
    groups.initialize(ep_size=world)
    x = (torch.arange(world, dtype=torch.float32)[:, None] + 10 * rank) \
        .repeat(1, 3).requires_grad_()
    out = comm.all_to_all(x, groups.get_expert_parallel_group())
    (out * (rank + 1.0)).sum().backward()
    return {"out": out.detach().numpy(), "grad": x.grad.numpy()}


def axis_case(rank, world, case, root):
    """``groups.axis_group`` of every mesh axis at ``case["ep_size"]``:
    {axis: [size, the group's global ranks (None: a group of one)]}."""
    from deepspeed_tpu_torch.utils import groups
    groups.destroy()
    groups.initialize(ep_size=case["ep_size"])
    out = {}
    for axis in groups.MESH_AXES:
        group, size = groups.axis_group(axis)
        out[axis] = [size, None if group is None else
                     torch.distributed.get_process_group_ranks(group)]
    return out


def step_error_case(rank, world, case, root):
    """The error one ``train_batch`` on this rank's rows of
    ``case["batch"]`` raises, as text."""
    engine = _engine(case)
    try:
        engine.train_batch(batch=rank_rows(case["batch"], rank, world, 1, 0))
    except ValueError as e:
        return f"ValueError: {e}"
    return "no error"


KINDS = {"engine": engine_case, "dropout": dropout_case,
         "refusal": refusal_case, "checkpoint": checkpoint_case,
         "ring": ring_case, "groups": groups_case,
         "all_to_all": all_to_all_case, "axis": axis_case,
         "step_error": step_error_case}
