"""KSVQE — the paper model (arXiv:2402.07220) (counterpart of
kvq_tpu/nn/ksvqe.py; reference KSVQE_model.py:1024-1506).

  (a) CLIP ViT-B/16 semantic tool over 4 keyframes;
  (b) frozen CONTRIQUE distortion tool + dist_adapter blended 0.2/0.8 on
      temporally-halved frames;
  (c) quality-aware region selection, one region per frame: hard argmax
      at eval, perturbed top-1 soft weights in training;
  (d) Swin-3D-Tiny trunk with CDM modulation after each stage >=
      tuning_stage: semantic cross-attention + spatial FiLM, distortion
      cross-attention + temporal self-attention + channel FiLM, combined
      (a1 * x_dist + a2 * x_sem) / 2;
  (e) the supervised contrastive distortion loss, returned beside the
      features.

Under the (data, fsdp) layout (parallel/fsdp.py) the contrastive loss
spans the whole batch, as JAX's jitted step computes it: with
``contrastive_group`` set, every rank's distortion tokens and labels are
gathered before it (``parallel/steps.py:gather_batch``, whose backward
keeps this rank's slice); without one (the default) it is this forward's
own rows'.

A training forward (``model.train()``) draws, from the one generator it is
given and in this order: the QRS noise, then each Swin block's two DropPath
masks.  The distortion tool sees the selected frames detached, and CONTRIQUE
keeps eval semantics (frozen BatchNorm), as in the JAX package.

An eval forward on the card without autograd replays its two halves, split
at QRS's pick, as CUDA graphs (``nn/eval_graphs.py``); a training forward
on the card under autograd replays each half as a forward and a backward
graph (the train capture, ``nn/train_graphs.py``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.device import index_tensor
from ..parallel.steps import gather_batch
from ..train.losses import distortion_contrastive_supervised
from .cdm import AdapterMLP, CrossAttention, DistFiLM, SemanticFiLM, TemporalAttention
from .clip_vit import CLIPVisionTower
from .contrique import CONTRIQUE
from .eval_graphs import EvalCapture, Graphs, engages
from .train_graphs import TrainCapture
from .layers import LayerNorm, PatchEmbed3D
from .regionnet import (
    RegionSelector,
    extract_region_hard,
    extract_region_weighted,
    keyframe_schedule,
)
from .swin import SwinConfig, make_stages


@dataclasses.dataclass(frozen=True)
class KSVQEConfig:
    """kvq_tpu's KSVQEConfig without the CONTRIQUE BatchNorm fold, which
    changes no result.  ``use_checkpoint`` (remat of the Swin blocks, the
    backbone config's ``checkpoint``, on unless it says false as
    config/Kwai_KSVQE*.yml do) changes no result either, only what a
    training forward keeps for its backward."""

    num_samples: int = 1
    sample_type: str = "topkpertubation"
    sigma: float = 0.5
    clip_location: int = 8
    cls_use: bool = True
    tuning_stage: int = 1
    a1: float = 1.0
    a2: float = 0.0
    anchor_size: int = 32
    region_k: int = 49
    patch_size: tuple[int, int, int] = (2, 4, 4)
    embed_dim: int = 96
    depths: tuple[int, ...] = (2, 2, 6, 2)
    num_heads: tuple[int, ...] = (3, 6, 12, 24)
    window_size: tuple[int, int, int] = (8, 7, 7)
    drop_path_rate: float = 0.1
    frag_biases: tuple[bool, ...] = (True, True, True, False)
    use_checkpoint: bool = True
    use_pallas: bool = False
    s2d_input: bool = False
    force_sem_gather: bool = False
    contrique_layers: tuple[int, ...] = (3, 4, 6, 3)
    clip_layers: int = 12
    clip_width: int = 768
    clip_heads: int = 12


def ksvqe_config(bb: dict | None) -> KSVQEConfig:
    """Build from the reference YAML backbone block
    (config/Kwai_KSVQE.yml:63-75)."""
    bb = bb or {}
    return KSVQEConfig(
        num_samples=int(bb.get("num_samples", 1)),
        sample_type=bb.get("sample_type", "topkpertubation"),
        sigma=float(bb.get("sigma", 0.5)),
        clip_location=int(bb.get("CLIP_location", 8)),
        cls_use=bool(bb.get("cls_use", True)),
        tuning_stage=int(bb.get("tuning_stage", 1)),
        a1=float(bb.get("a1", 1.0)),
        a2=float(bb.get("a2", 0.0)),
        use_checkpoint=bool(bb.get("checkpoint", True)),
        use_pallas=bool(bb.get("use_pallas", False)),
        s2d_input=bool(bb.get("s2d_input", False)),
        drop_path_rate=float(bb.get("drop_path_rate", 0.1)),
        anchor_size=int(bb.get("anchor_size", 32)),
        region_k=int(bb.get("region_k", 49)),
        patch_size=tuple(bb.get("patch_size", (2, 4, 4))),
        depths=tuple(bb.get("depths", (2, 2, 6, 2))),
        num_heads=tuple(bb.get("num_heads", (3, 6, 12, 24))),
        embed_dim=int(bb.get("embed_dim", 96)),
        window_size=tuple(bb.get("window_size", (8, 7, 7))),
        contrique_layers=tuple(bb.get("contrique_layers", (3, 4, 6, 3))),
        clip_layers=int(bb.get("clip_layers", 12)),
        clip_width=int(bb.get("clip_width", 768)),
        clip_heads=int(bb.get("clip_heads", 12)),
    )


class KSVQE(nn.Module):
    contrastive_group = None  # the ranks whose rows the loss spans

    def __init__(self, config: KSVQEConfig):
        super().__init__()
        cfg = self.config = config
        self.CLIP_tool = CLIPVisionTower(
            width=cfg.clip_width, layers=cfg.clip_layers, heads=cfg.clip_heads,
            clip_location=cfg.clip_location, cls_use=cfg.cls_use)
        self.distortion_tool = CONTRIQUE(anchor_size=cfg.anchor_size,
                                         layers=cfg.contrique_layers)
        self.dist_adapter = AdapterMLP(128, 128)
        self.selector = RegionSelector(
            k=cfg.region_k, anchor_size=cfg.anchor_size,
            num_samples=cfg.num_samples, sample_type=cfg.sample_type,
            sigma=cfg.sigma)
        self.patch_embed = PatchEmbed3D(cfg.patch_size, cfg.embed_dim)
        self.layers = make_stages(SwinConfig(
            patch_size=cfg.patch_size, embed_dim=cfg.embed_dim,
            depths=cfg.depths, num_heads=cfg.num_heads,
            window_size=cfg.window_size, drop_path_rate=cfg.drop_path_rate,
            frag_biases=cfg.frag_biases, use_pallas=cfg.use_pallas,
            use_checkpoint=cfg.use_checkpoint))
        n_stages = len(cfg.depths)
        self.num_features = int(cfg.embed_dim * 2 ** (n_stages - 1))
        self.norm = LayerNorm(self.num_features)

        # channel dims follow the reference's clamped 2^(l+1) rule
        # (KSVQE_model.py:1160-1163)
        names = ("semantic_adapter", "distortion_adapter", "semantic_cross",
                 "distortion_cross", "distortion_self", "semantic_mod",
                 "distortion_mod")
        mods = {k: [] for k in names}
        for l in range(cfg.tuning_stage, n_stages):
            dim = int(cfg.embed_dim * 2 ** (min(l, n_stages - 2) + 1))
            heads = cfg.num_heads[l]
            mods["semantic_adapter"].append(AdapterMLP(cfg.clip_width, dim))
            mods["distortion_adapter"].append(AdapterMLP(128, dim))
            mods["semantic_cross"].append(
                CrossAttention(dim, heads, cfg.use_pallas))
            mods["distortion_cross"].append(
                CrossAttention(dim, heads, cfg.use_pallas))
            mods["distortion_self"].append(
                TemporalAttention(dim, heads, cfg.use_pallas))
            mods["semantic_mod"].append(SemanticFiLM(dim))
            mods["distortion_mod"].append(DistFiLM(dim))
        for k in names:
            setattr(self, k, nn.ModuleList(mods[k]))
        n_mod = n_stages - cfg.tuning_stage
        self.a1 = nn.Parameter(torch.full((n_mod, 1), float(cfg.a1)))
        self.a2 = nn.Parameter(torch.full((n_mod, 1), float(cfg.a2)))
        self._graphs = {"eval": Graphs(EvalCapture),
                        "train": Graphs(TrainCapture)}

    def _frames(self, fragment) -> int:
        """The frames of a fragment, (B, T, H, W, C) or s2d-packed
        (B, T/2, H/4, W/4, 96)."""
        pt = self.config.patch_size[0]
        if not self.config.s2d_input:
            return fragment.shape[1]
        if pt != 2:
            raise ValueError("s2d_input requires temporal patch 2")
        return fragment.shape[1] * pt

    def _extract(self, fragment, sel, anchor):
        """The regions QRS picked (``sel``) of ``fragment``: weighted by
        the soft pick in training, indexed by the hard pick at eval."""
        extract = (extract_region_weighted if self.training
                   else extract_region_hard)
        return extract(fragment, sel, anchor, self.selector.k_side)

    def _embed_packed(self, fragment, sel):
        """The picked regions + patch embed on an s2d-packed fragment
        (B, T/2, H/4, W/4, 96).

        Keyframe-group boundaries fall at odd frame indices, so the two
        frames of a packed pair can select different regions: each frame's
        choice is applied to its own channel half (ti=0 -> [:48], ti=1 ->
        [48:]).  The even half, unpacked, is the distortion tool's input.
        Returns (trunk tokens (B, T/2, 56, 56, C), dist pixels
        (B, T/2, 224, 224, 3))."""
        pt, ph, pw = self.config.patch_size
        B, T2, Hp, Wp, K = fragment.shape
        Cs = K // pt
        anchor = self.selector.anchor // ph
        halves = [
            self._extract(fragment[..., ti * Cs:(ti + 1) * Cs],
                          sel[:, ti::pt], anchor)
            for ti in range(pt)
        ]
        x = self.patch_embed(torch.cat(halves, dim=-1), packed=True)
        ev = halves[0].detach()
        _, _, h2, w2, _ = ev.shape
        c = Cs // (ph * pw)
        dist_in = (ev.reshape(B, T2, h2, w2, ph, pw, c)
                   .permute(0, 1, 2, 4, 3, 5, 6)
                   .reshape(B, T2, h2 * ph, w2 * pw, c))
        return x, dist_in

    def forward(self, batch, gen=None):
        """``gen``: the torch.Generator of a training forward's draws.

        The forward is three calls: :meth:`semantic_segment`, QRS's pick
        (:meth:`pick`) and :meth:`trunk_segment`.  An eval forward on the
        card without autograd replays the two segments as CUDA graphs
        (:mod:`.eval_graphs`), the pick running eagerly between them; so
        does a training forward on the card under autograd, each segment's
        backward a graph too (:mod:`.train_graphs`), once its tensors have
        been seen twice; every other forward makes the three calls
        eagerly."""
        kind = engages(self, batch)
        if kind is not None:
            out = self._graphs[kind](self, batch, gen)
            if out is not None:  # None: no capture holds or may be made yet
                return out
        fragment, cls_attn, pat_tokens = self.semantic_segment(
            batch["fragment"], batch["resize_video"])
        sel = self.pick(cls_attn, fragment, gen)
        return self.trunk_segment(fragment, sel, pat_tokens,
                                  batch["dis_label"], gen)

    def semantic_segment(self, fragment, revideo):
        """The forward up to QRS's pick: the views cast to the compute
        dtype, the keyframes and the CLIP tool.  Returns (the fragment in
        the compute dtype, cls_attn (B, n_key, L), pat_tokens
        (B, n_key, L, D))."""
        dt = self.patch_embed.proj.weight.dtype
        revideo = revideo.to(dt)
        fragment = fragment.to(dt)
        B, T = fragment.shape[0], self._frames(fragment)
        if T != revideo.shape[1]:
            raise ValueError(f"fragment {tuple(fragment.shape)} and resize "
                             f"view {tuple(revideo.shape)} disagree on T")
        keyframes, _ = keyframe_schedule(T)
        n_key = len(keyframes)
        kf = revideo.index_select(1, index_tensor(keyframes, revideo.device))
        cls_attn, _cls_token, pat_tokens = self.CLIP_tool(
            kf.reshape(B * n_key, *kf.shape[2:]))
        L = cls_attn.shape[-1]
        return (fragment, cls_attn.reshape(B, n_key, L),
                pat_tokens.reshape(B, n_key, L, -1))

    def _anchor_grid(self, fragment) -> tuple[int, int]:
        """The anchor grid of ``fragment`` (as :meth:`semantic_segment`
        returns it)."""
        anchor = self.selector.anchor
        if self.config.s2d_input:
            anchor //= self.config.patch_size[1]
        return fragment.shape[2] // anchor, fragment.shape[3] // anchor

    def pick(self, cls_attn, fragment, gen=None):
        """QRS's pick (``RegionSelector.select``) on the anchor grid of
        ``fragment`` (as :meth:`semantic_segment` returns it): region
        indices (B, T) at eval, soft weights (B, T, regions) in training,
        drawn from ``gen``."""
        _, group_id = keyframe_schedule(self._frames(fragment))
        return self.selector.select(cls_attn, group_id,
                                    self._anchor_grid(fragment),
                                    self.training, gen)

    def pick_stand_in(self, cls_attn, fragment):
        """What a training :meth:`pick` returns, with no draw: region 0 of
        every frame as a one-hot (B, T, regions) in ``cls_attn``'s dtype,
        a leaf that needs a gradient."""
        n = self.selector.n_regions(self._anchor_grid(fragment))
        sel = torch.zeros((fragment.shape[0], self._frames(fragment), n),
                          dtype=cls_attn.dtype, device=cls_attn.device)
        sel[..., 0] = 1
        return sel.requires_grad_()

    def drop_path_draws(self, batch: int, gen, device) -> list:
        """Every Swin block's DropPath multipliers (``(dp1, dp2)``, each
        None where nothing drops), stage by stage and block by block, drawn
        from ``gen`` as :meth:`trunk_segment` draws them when it is given
        none."""
        return [[blk.drop_path_multipliers(batch, gen, device)
                 for blk in stage.blocks] for stage in self.layers]

    def trunk_segment(self, fragment, sel, pat_tokens, dis_label, gen=None,
                      dps=None):
        """The forward from QRS's pick ``sel`` on: the picked regions and
        the patch embed, CONTRIQUE and the distortion adapter, the
        contrastive loss, the Swin stages with CDM after each stage from
        ``tuning_stage``, and the final norm.  ``dps``: the blocks'
        DropPath multipliers (:meth:`drop_path_draws`), drawn from ``gen``
        block by block when None.  Returns (features, the contrastive
        loss)."""
        cfg = self.config
        keyframes, group_id = keyframe_schedule(self._frames(fragment))
        n_key = len(keyframes)
        L = pat_tokens.shape[2]
        # CDM sees the temporally-halved frames; each attends to its
        # keyframe's tokens.  Uniform group runs let the semantic k/v run on
        # the n_key distinct keyframe token sets with queries grouped.
        gid_half = group_id[::2]
        tg = len(gid_half) // max(n_key, 1)
        sem_grouped = not cfg.force_sem_gather and gid_half == tuple(
            g for g in range(n_key) for _ in range(tg))
        gid_half_ix = index_tensor(gid_half, fragment.device)

        if cfg.s2d_input:
            x, dist_in = self._embed_packed(fragment, sel)
        else:
            x_sel = self._extract(fragment, sel, self.selector.anchor)
            x = self.patch_embed(x_sel)
            dist_in = x_sel.detach()[:, ::2]
        dist_tok = self.distortion_tool(dist_in)  # (B, T/2, G, 128) f32
        dist_tok = 0.2 * self.dist_adapter(dist_tok) + 0.8 * dist_tok
        if self.contrastive_group is None:
            dis_loss = distortion_contrastive_supervised(dist_tok, dis_label)
        else:
            dis_loss = distortion_contrastive_supervised(
                gather_batch(dist_tok.float(), self.contrastive_group),
                gather_batch(dis_label, self.contrastive_group))

        ts = cfg.tuning_stage
        for l, stage in enumerate(self.layers):
            x = stage(x, gen, None if dps is None else dps[l])
            if l < ts:
                continue
            m = l - ts
            n, t, h, w, c = x.shape

            pt_key = self.semantic_adapter[m](pat_tokens)  # (B, n_key, L, c)
            xs = x.reshape(n * t, h * w, c)
            if sem_grouped:
                enh = self.semantic_cross[m](
                    x.reshape(n * n_key, tg * h * w, c),
                    pt_key.reshape(n * n_key, L, c),
                ).reshape(n * t, h * w, c)
            else:
                enh = self.semantic_cross[m](
                    xs, pt_key[:, gid_half_ix].reshape(n * t, L, c))
            fors = self.semantic_mod[m](
                enh.reshape(n * t, h, w, c), x.reshape(n * t, h, w, c)
            ).reshape(n, t, h, w, c)

            G = dist_tok.shape[2]
            dtk = self.distortion_adapter[m](dist_tok).reshape(n * t, G, c)
            denh = self.distortion_cross[m](xs, dtk)
            denh = (denh.reshape(n, t, h * w, c).transpose(1, 2)
                    .reshape(n * h * w, t, c))
            denh = self.distortion_self[m](denh)
            denh = (denh.reshape(n, h * w, t, c).transpose(1, 2)
                    .reshape(n, t, h, w, c))
            ford = self.distortion_mod[m](
                denh, x.reshape(n, t * h * w, c)).reshape(n, t, h, w, c)
            x = (self.a1[m].to(x.dtype) * ford
                 + self.a2[m].to(x.dtype) * fors) / 2

        return self.norm(x), dis_loss
