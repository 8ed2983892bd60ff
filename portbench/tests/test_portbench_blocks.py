"""The reference's train step: in blocks of rows it is the whole batch's
step in another order of sums, and KSVQE's step (which takes no blocks)
is today's to the bit.  On the card: the memory and time of the step at
FAST-VQA-B's published shapes, whole and in blocks of four rows
(``pytest -m cuda -s portbench/tests/test_portbench_blocks.py``)."""

import contextlib
import time

import pytest
import torch

from portbench.harness import inputs
from portbench.harness.entries import _device_batch, leaf_gap
from portbench.reference.layers import DrawTape
from portbench.reference.network import (
    Network,
    TrainStep,
    is_frozen,
    plcc_loss,
    schedule_factor,
)
from portbench.reference.precision import Float8Products, exact_float32
from portbench.tests.tiny import tiny_spec

CPU = torch.device("cpu")


class FrozenTrainStep:
    """``TrainStep`` as it stood before it read the optimizer's groups,
    the loss weights and row blocks from the schedule: one AdamW group,
    0.3 x KSVQE's contrastive loss."""

    def __init__(self, model, schedule, seed, device):
        self.model = model.train()
        self.params = [p for n, p in model.named_parameters()
                       if not is_frozen(model.key, n)]
        for n, p in model.named_parameters():
            p.requires_grad_(not is_frozen(model.key, n))
        opt = schedule["optimizer"]
        spe = int(schedule["steps_per_epoch"])
        self.warmup = int(float(schedule["warmup_epochs"]) * spe)
        self.total = int(float(schedule["num_epochs"]) * spe)
        self.lr = float(opt["lr"])
        self.opt = torch.optim.AdamW(
            self.params, lr=self.lr * schedule_factor(0, self.warmup,
                                                      self.total),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=float(opt["wd"]),
            foreach=False)
        self.decay = float(schedule["ema_decay"])
        self.contra_w = 0.3
        self.ema = [p.detach().clone() for p in model.parameters()]
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.steps = 0

    def step(self, batch):
        feat, dis = self.model.features(batch, self.gen)
        self.features = feat.detach()
        scores = self.model.head(feat, self.gen)
        y = batch["label"].reshape(-1, 1).float()
        loss = plcc_loss(scores.float(), y)
        if dis is not None:
            loss = loss + self.contra_w * dis
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = [None if p.grad is None else p.grad.detach().clone()
                 for p in self.params]
        self.opt.step()
        self.steps += 1
        for g in self.opt.param_groups:
            g["lr"] = self.lr * schedule_factor(self.steps, self.warmup,
                                                self.total)
        with torch.no_grad():
            for e, p in zip(self.ema, self.model.parameters()):
                e.mul_(self.decay).add_(p, alpha=1.0 - self.decay)
        return float(loss.detach()), grads


def _setup(cell, seed, device=CPU):
    """(a maker of the cell's seeded reference network, its schedule, its
    first three batches)."""
    s = tiny_spec(cell)
    cfg, mix = s["config"], s["mix"]
    block = cfg["model"]

    def net():
        n = Network(block).to(device)
        n.load_state_dict(inputs.make_state_dict(inputs.state_shapes(n),
                                                 block, seed, device))
        return n
    sched = {**cfg["schedule"], "steps_per_epoch": cfg["steps_per_epoch"]}
    pool = inputs.make_pool(mix, seed, device)
    return net, sched, [_device_batch(pool[i], mix["fields"], device)
                        for i in range(3)]


def _three_steps(step, batches, mode=contextlib.nullcontext):
    """(losses, step 1's features and gradients, the change after three
    steps, the generator's state after each step)."""
    p0 = [p.detach().clone() for p in step.params]
    losses, gens = [], []
    for i, b in enumerate(batches):
        with mode():
            loss, g = step.step(b)
        losses.append(loss)
        gens.append(step.gen.get_state())
        if i == 0:
            feats, grads = step.features.clone(), g
    change = [p.detach() - q for p, q in zip(step.params, p0)]
    return losses, feats, grads, change, gens


@pytest.mark.parametrize("seed", [11, 2147483747])
def test_row_blocks_are_the_whole_batch(seed):
    """Blocks of 2 rows against the whole batch of 4, under fast-b.yml's
    optimizer and loss (two AdamW groups, the rank loss), DropPath 0.1 and
    the head's dropout 0.5 drawn: each loss and step 1's features within
    1e-5 relative, each gradient's difference within 1e-5 of the larger
    of its norm and the median leaf's (leaves whose gradient is nought to
    rounding, as the head's last bias under the PLCC loss, have no
    relative error), the generator in the same state after each step.
    The change after three steps is compared as the judge compares it
    (the norm of each leaf's entries whose gradient is above a thousandth
    of the median leaf's rms, against the larger of its norm and the
    median leaf's): AdamW divides each entry's rounding by that entry's
    own size, so entry by entry the change of the small entries differs
    by up to ~5e-5 of their leaf at float32's sum order."""
    net, sched, batches = _setup("swin-train-fast", seed)
    whole = _three_steps(TrainStep(net(), sched, seed, CPU), batches)
    blocks = _three_steps(TrainStep(net(), sched, seed, CPU, rows=2),
                          batches)
    for a, b in zip(whole[0], blocks[0]):
        assert abs(b - a) <= 1e-5 * abs(a), (a, b)
    assert float((blocks[1] - whole[1]).norm()) <= 1e-5 * float(
        whole[1].norm())
    norms = [float(g.norm()) for g in whole[2]]
    med = sorted(norms)[len(norms) // 2]
    for a, b, n in zip(whole[2], blocks[2], norms):
        assert float((b - a).norm()) <= 1e-5 * max(n, med)
    rms = [n / g.numel() ** 0.5 for g, n in zip(whole[2], norms)]
    floor = 1e-3 * sorted(rms)[len(rms) // 2]
    masks = [g.abs() >= floor for g in whole[2]]
    keep = [i for i, m in enumerate(masks) if bool(m.any())]
    worst, _ = leaf_gap([float(blocks[3][i][masks[i]].norm()) for i in keep],
                        [float(whole[3][i][masks[i]].norm()) for i in keep])
    assert worst <= 1e-5
    for a, b in zip(whole[4], blocks[4]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("control", [False, True])
def test_ksvqe_step_is_todays(control):
    """KSVQE's tiny train cell, which states no row blocks and no loss
    weights: the step's losses, features, gradients, change after three
    steps and generator are today's bit for bit, the reference's and
    the float8 control's."""
    net, sched, batches = _setup("ksvqe-train", 5)
    mode = Float8Products if control else contextlib.nullcontext
    old = _three_steps(FrozenTrainStep(net(), sched, 5, CPU), batches, mode)
    new = _three_steps(TrainStep(net(), sched, 5, CPU), batches, mode)
    assert old[0] == new[0]
    assert torch.equal(old[1], new[1])
    for lists in zip(old[2:], new[2:]):
        for a, b in zip(*lists):
            assert torch.equal(a, b)


def test_blocks_refuse_coupled_rows():
    """Row blocks raise rather than guess: for KSVQE (QRS's picks and the
    contrastive loss couple the rows), for a BatchNorm in train mode, and
    for a draw that does not lead with the batch's rows."""
    net, sched, _ = _setup("ksvqe-train", 5)
    with pytest.raises(ValueError, match="KSVQE"):
        TrainStep(net(), sched, 5, CPU, rows=2)
    net, sched, _ = _setup("swin-train-fast", 5)
    n = net()
    n.swin_tiny_grpb_head.norm = torch.nn.BatchNorm1d(4)
    with pytest.raises(ValueError, match="BatchNorm"):
        TrainStep(n, sched, 5, CPU, rows=2)
    tape = DrawTape(torch.Generator().manual_seed(0), 4)
    tape.draw((8, 3), 0.1, CPU)
    with pytest.raises(ValueError, match="rows"):
        tape.draw((6,), 0.1, CPU)


def test_replay_slices_each_draw_to_its_rows():
    """A draw of 2 x B leading rows (each row's two) replays as its
    block's rows' share; a block that asks for other draws raises."""
    tape = DrawTape(torch.Generator().manual_seed(0), 4)
    a = tape.draw((4, 3), 0.5, CPU)
    b = tape.draw((8,), 0.5, CPU)
    tape.replay(2, 4)
    assert torch.equal(tape.draw((2, 3), 0.5, CPU), a[2:4])
    assert torch.equal(tape.draw((4,), 0.5, CPU), b[4:8])
    assert tape.replayed_all()
    tape.replay(0, 2)
    with pytest.raises(ValueError, match="shape"):
        tape.draw((2, 5), 0.5, CPU)


FAST_B = {"type": "swin_tiny_grpb", "compute_dtype": "bfloat16",
          "args": {"swin_tiny_grpb": {"backbone": {},
                                      "head": {"hidden_channels": 64}}}}
FAST_B_SCHEDULE = {"num_epochs": 30, "warmup_epochs": 2.5, "ema_decay": 0.999,
                   "rank_loss_weight": 0.3, "steps_per_epoch": 100,
                   "optimizer": {"lr": 1e-3, "backbone_lr_mult": 0.1,
                                 "wd": 0.05}}


def _fast_b_step(rows, dev):
    """One reference step of FAST-VQA-B at fast-b.yml's published train
    input, B=16 and technical (32, 224, 224, 3), from a seeded state:
    (peak bytes allocated, seconds, loss, step 1's features), or the
    out-of-memory error's text."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.device(dev):
        net = Network(FAST_B)
    net.load_state_dict(inputs.make_state_dict(inputs.state_shapes(net),
                                               FAST_B, 7, dev))
    gen = torch.Generator(device=dev).manual_seed(inputs.input_seed(7))
    batch = {"technical": torch.randn((16, 32, 224, 224, 3), generator=gen,
                                      device=dev),
             "label": torch.randn((16,), generator=gen, device=dev)}
    step = TrainStep(net, FAST_B_SCHEDULE, 7, dev, rows)
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    try:
        loss, _ = step.step(batch)
        torch.cuda.synchronize(dev)
    except torch.cuda.OutOfMemoryError as e:
        return {"rows": rows, "out_of_memory": str(e).splitlines()[0],
                "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    return {"rows": rows, "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "seconds": time.perf_counter() - t, "loss": loss,
            "features": step.features.cpu()}


@pytest.mark.cuda
def test_fast_b_step_in_blocks_fits():
    """The reference's step at FAST-VQA-B's published shapes, float32
    with TF32 off: in blocks of 4 rows it peaks under 40 GB; the whole
    batch's step is read beside it (or its running out of memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    exact_float32()
    dev = torch.device("cuda")
    _fast_b_step(4, dev)  # the card's libraries load: out of the seconds
    whole = _fast_b_step(None, dev)
    blocks = _fast_b_step(4, dev)
    card = torch.cuda.get_device_name(dev)
    for r in (blocks, whole):
        print(f"fast-b reference step on {card}: " + ", ".join(
            f"{k} {v!r}" for k, v in r.items() if k != "features"))
    assert "out_of_memory" not in blocks
    assert blocks["peak_bytes"] < 40e9
    if "out_of_memory" not in whole:
        assert abs(blocks["loss"] - whole["loss"]) <= 1e-5 * abs(
            whole["loss"])
        assert float((blocks["features"] - whole["features"]).norm()) <= (
            1e-5 * float(whole["features"].norm()))
