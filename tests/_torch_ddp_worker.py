"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py,
and the (data, fsdp) layout's, tests/test_torch_fsdp.py).

    python tests/_torch_ddp_worker.py RANK WORLD RENDEZVOUS IN_DIR OUT_DIR \
        SCENARIO [SCENARIO ...]

Joins a gloo group of WORLD processes through the ``file://`` rendezvous
RENDEZVOUS (``parallel.init_distributed`` on the CPU), runs each named
scenario on the inputs the test wrote under IN_DIR, and saves what each
gave (or its traceback) to ``OUT_DIR/rank{RANK}.pt``.  Imports torch and
kvq_tpu_torch only.
"""

import os
import sys
import traceback

import numpy as np
import torch


def _load(inp, name):
    return torch.load(os.path.join(inp, name), weights_only=False)


def _my_rows(batch, rank, world):
    b = len(batch["label"]) // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def _grads(model):
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()
            if p.grad is not None}


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _train_step(inp, out, name):
    """One DDP step of the Trainer on this rank's half of the batch, from
    the weights of the config's ``load_path``."""
    from kvq_tpu_torch.parallel import rank, world
    from kvq_tpu_torch.train.trainer import Trainer

    d = _load(inp, f"{name}.pt")
    tr = Trainer(d["config"], device="cpu", seed=0, steps_per_epoch=1)
    if tr.is_ksvqe:  # the head in eval, as the JAX reference's
        tr.model.KSVQE_head.dropout_ratio = 0.0
    aux = tr.train_step(_my_rows(d["batch"], rank(), world()))
    return {"aux": aux, "grads": _grads(tr.model),
            "trainable": [n for n, p in tr.model.named_parameters()
                          if p.requires_grad],
            "buffers": {n: b.clone() for n, b in tr.model.named_buffers()},
            "params": _params(tr.model)}


def ksvqe(inp, out):
    return _train_step(inp, out, "ksvqe")


def svqa(inp, out):
    return _train_step(inp, out, "svqa")


def svqa_bf16(inp, out):
    """The Trainer's DDP step of SimpleVQA in its shipped compute dtype,
    bf16 (the synced statistics in f32)."""
    from kvq_tpu_torch.parallel import rank, world
    from kvq_tpu_torch.train.trainer import Trainer

    d = _load(inp, "svqa.pt")
    cfg = dict(d["config"], model=dict(d["config"]["model"],
                                       compute_dtype="bfloat16"))
    tr = Trainer(cfg, device="cpu", seed=0, steps_per_epoch=1)
    aux = tr.train_step(_my_rows(d["batch"], rank(), world()))
    return {"aux": aux, "params": _params(tr.model),
            "buffers": {n: b.clone() for n, b in tr.model.named_buffers()}}


def svqa_f64(inp, out):
    """The DDP step's pieces on the SimpleVQA network in float64: the synced
    BatchNorm, the state broadcast, this rank's loss and backward, the
    gradient all-reduce."""
    from kvq_tpu_torch.core.checkpoint import load_weights
    from kvq_tpu_torch.models.vqa_network import VQANetwork
    from kvq_tpu_torch.nn.resnet import sync_batchnorm
    from kvq_tpu_torch.parallel import rank, world
    from kvq_tpu_torch.parallel.steps import broadcast_state, reduce_gradients
    from kvq_tpu_torch.train.losses import total_loss

    d = _load(inp, "svqa.pt")
    net = VQANetwork(d["config"])
    load_weights(net, d["config"]["load_path"])
    net = net.double().train()
    sync_batchnorm(net)
    broadcast_state(net)
    b = {k: torch.from_numpy(v).double()
         for k, v in _my_rows(d["batch"], rank(), world()).items()}
    total_loss(net(b), b["label"], None)[0].backward()
    reduce_gradients(net.parameters())
    return {"grads": _grads(net)}


def world_one(inp, out):
    """The DDP route at world 1 against the one-process Trainer: two steps
    with the random parts on; every difference (expected 0)."""
    from kvq_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)  # the same summation order in both trainers
    d = _load(inp, "world_one.pt")
    ddp = Trainer(dict(d["config"], ddp=True), device="cpu", seed=0,
                  steps_per_epoch=2)
    plain = Trainer(d["config"], device="cpu", seed=0, steps_per_epoch=2)
    assert ddp.ddp and not plain.ddp
    diffs = {}
    for i, batch in enumerate(d["batches"]):
        a, b = ddp.train_step(batch), plain.train_step(batch)
        diffs[f"loss {i}"] = max(abs(a[k] - b[k]) for k in a)
        ga, gb = _grads(ddp.model), _grads(plain.model)
        assert ga.keys() == gb.keys()
        diffs[f"grad {i}"] = max(float(np.abs(ga[n] - gb[n]).max())
                                 for n in ga)
    diffs["params"] = max((p - q).abs().max().item() for p, q in
                          zip(ddp.params, plain.params))
    diffs["ema"] = max((p - q).abs().max().item() for p, q in
                       zip(ddp.ema, plain.ema))
    return diffs


def evaluate(inp, out):
    """The gathered eval of the val split: Trainer.evaluate's metrics, this
    rank's rows and the gathered ones, and cli.test into a file of this
    rank's."""
    from kvq_tpu_torch.cli import test as cli_test
    from kvq_tpu_torch.data import datasets as PD
    from kvq_tpu_torch.data.pipeline import build_loaders
    from kvq_tpu_torch.parallel import loader_shard, rank
    from kvq_tpu_torch.parallel.steps import gather_rows
    from kvq_tpu_torch.train.evaluator import Evaluator
    from kvq_tpu_torch.train.trainer import Trainer

    PD.NATIVE = False
    cfg = _load(inp, "cli.pt")["config"]
    _, val = build_loaders(cfg, loader_shard())
    metrics = Trainer(cfg, device="cpu", seed=0).evaluate(val.epoch(0))
    rows = Evaluator(cfg, device="cpu")._columns(val.epoch(0), "label")
    path = os.path.join(out, f"output_rank{rank()}.txt")
    return {"metrics": tuple(metrics), "rows": rows,
            "gathered": gather_rows(*rows),
            "cli": cli_test.run(cfg, path, device="cpu"),
            "shard": val.shard}


def cli_train(inp, out):
    """cli.train for one epoch into a workdir (and log_dir) of this
    rank's."""
    import torch.distributed as dist

    from kvq_tpu_torch.cli import train as cli_train_mod
    from kvq_tpu_torch.data import datasets as PD
    from kvq_tpu_torch.parallel import rank
    from kvq_tpu_torch.train.trainer import Trainer

    PD.NATIVE = False
    cfg = _load(inp, "cli.pt")["config"]
    work = os.path.join(out, f"work_rank{rank()}")
    tr = cli_train_mod.run(cfg, work, "val", epochs=1, seed=0, device="cpu",
                           log_dir=work)
    files = sorted(os.listdir(work))
    dist.barrier()  # rank 0's file is written
    # every rank resumes rank 0's file with its own generator
    resumed = Trainer(cfg, device="cpu", seed=5)
    resumed.load(os.path.join(out, "work_rank0", "tiny_last_state.pt"))
    return {"files": files, "step": tr.step, "params": _params(tr.model),
            "ema": [e.clone() for e in tr.ema],
            "generator": tr.gen.get_state(),
            "resumed_generator": resumed.gen.get_state()}


def refusals(inp, out):
    """A group of two ranks without ``ddp``, and a train batch of 1 a rank:
    the messages of the errors raised."""
    from kvq_tpu_torch.parallel import rank, world
    from kvq_tpu_torch.train.trainer import Trainer

    d = _load(inp, "svqa.pt")
    got = {}
    cfg = {k: v for k, v in d["config"].items() if k != "ddp"}
    try:
        Trainer(cfg, device="cpu")
    except ValueError as e:
        got["no ddp"] = str(e)
    tr = Trainer(d["config"], device="cpu")
    one = {k: v[rank():rank() + 1] for k, v in d["batch"].items()}
    try:
        tr.train_step(one)
    except ValueError as e:
        got["batch of 1"] = str(e)
    got["world"] = world()
    return got


# ------------------------------------------------- the (data, fsdp) layout
def _equal_on_ranks(tensors) -> bool:
    """Whether this rank's tensors equal rank 0's, bit for bit."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1).double() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    return bool(torch.equal(flat, ref))


def _sharded(d, model, dtype=None):
    """(step_fn, state, result): one (data 2, fsdp 2) step of ``model`` on
    this rank's rows of ``d["batch"]`` (the forward in ``dtype``, None:
    the config's), with what every rank reports."""
    from kvq_tpu_torch.parallel import fsdp, rank, world
    from kvq_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data=2, fsdp=2)
    step, state = fsdp.make_sharded_train_step(
        model, d["config"], mesh, min_size=d["min_size"], dtype=dtype)
    rows = {k: torch.from_numpy(v) for k, v in
            _my_rows(d["batch"], rank(), world()).items()}
    aux = step(state, rows)
    idx = [i for i, t in enumerate(state.trainable) if t]
    whole = state.whole()
    return step, state, {
        "aux": {k: float(v) for k, v in aux.items()},
        "shards": {n: (tuple(p.shape), a) for n, p, a in
                   zip(state.names, state.params, state.axes)},
        "bytes": state.state_bytes(), "step": state.step,
        "params_equal_rank0": _equal_on_ranks(whole.values()),
        "grads": dict(zip((state.names[i] for i in idx), state.gather(
            (state.params[i].grad for i in idx), idx))),
        "params": whole,
        "buffers": {n: b.clone() for n, b in model.named_buffers()}}


def fsdp_ksvqe(inp, out):
    """The tiny KSVQE's sharded step and its sharded eval after it; rank 0
    keeps the whole tensors."""
    from kvq_tpu_torch.core.checkpoint import load_weights
    from kvq_tpu_torch.models.vqa_network import build_train_model
    from kvq_tpu_torch.parallel import fsdp, rank, world

    d = _load(inp, "fsdp_ksvqe.pt")
    model = build_train_model(d["config"], "cpu", 0)
    load_weights(model, d["config"]["load_path"])
    model.KSVQE_head.dropout_ratio = 0.0  # the head in eval, as JAX's
    _, state, res = _sharded(d, model)
    res["ema"] = state.whole(use_ema=True)
    res["moments"] = state.moments()
    eval_rows = _my_rows(d["eval_batch"], rank(), world())
    res["eval"] = fsdp.make_sharded_eval_step(model, d["config"])(
        state, [eval_rows])
    if rank():
        for k in ("grads", "params", "ema", "moments", "buffers"):
            res.pop(k)
    return res


def fsdp_svqa(inp, out):
    """The tiny SimpleVQA's sharded step in float32 (BatchNorm over the
    whole batch)."""
    from kvq_tpu_torch.core.checkpoint import load_weights
    from kvq_tpu_torch.models.vqa_network import build_train_model
    from kvq_tpu_torch.parallel import rank

    d = _load(inp, "fsdp_svqa.pt")
    model = build_train_model(d["config"], "cpu", 0)
    load_weights(model, d["config"]["load_path"])
    _, _, res = _sharded(d, model)
    res["buffers_equal_rank0"] = _equal_on_ranks(
        [b for n, b in model.named_buffers() if "running_" in n])
    res.pop("grads")
    if rank():
        res.pop("params")
        res.pop("buffers")
    return res


def fsdp_svqa_f64(inp, out):
    """The same step in float64: its reduced gradient (rank 0)."""
    from kvq_tpu_torch.core.checkpoint import load_weights
    from kvq_tpu_torch.models.vqa_network import build_train_model
    from kvq_tpu_torch.parallel import rank

    d = _load(inp, "fsdp_svqa.pt")
    model = build_train_model(d["config"], "cpu", 0)
    load_weights(model, d["config"]["load_path"])
    _, _, res = _sharded(d, model.double(), torch.float64)
    return {"grads": res["grads"]} if rank() == 0 else {}


def fsdp_dryrun(inp, out):
    from kvq_tpu_torch.parallel import world
    from kvq_tpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(world(), "cpu")


SCENARIOS = {f.__name__: f for f in (ksvqe, svqa, svqa_bf16, svqa_f64,
                                     world_one, evaluate, cli_train,
                                     refusals, fsdp_ksvqe, fsdp_svqa,
                                     fsdp_svqa_f64, fsdp_dryrun)}


def main():
    rank_, world_, rdv, inp, out, *scenarios = sys.argv[1:]
    os.environ.update(RANK=rank_, WORLD_SIZE=world_, LOCAL_RANK=rank_)
    torch.set_num_threads(2)
    import torch.distributed as dist

    from kvq_tpu_torch.parallel import init_distributed

    init_distributed("cpu", init_method=f"file://{rdv}")
    results = {}
    try:
        for name in scenarios:
            try:
                results[name] = SCENARIOS[name](inp, out)
            except Exception:  # reported by the test that reads it
                results[name] = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    torch.save(results, os.path.join(out, f"rank{rank_}.pt"))


if __name__ == "__main__":
    main()
