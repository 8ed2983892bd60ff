"""Model composition — the counterpart of kvq_tpu/models/vqa_network.py and
of the reference ``VQA_Network`` (models/model.py:18-121): one
``<key>_backbone`` + ``<key>_head`` per key of ``config['model']['args']``
(:func:`build_head`, kvq_tpu/models/heads_util.py).  Ported keys:

  - ``KSVQE`` and the Swin-T-3D keys ``swin_tiny``, ``swin_tiny_grpb``
    (FAST-VQA), ``swin_tiny_grpb_m`` and ``swin_small``, each with a
    VQAHead;
  - ``simpleVQA``: :class:`~kvq_tpu_torch.nn.resnet.FeatureResNet`
    (``backbone.layers``, default (3, 4, 6, 3)) with a SimpleVQAHead;
  - ``conv_tiny``: :class:`~kvq_tpu_torch.nn.convnext.ConvNeXt3D` at its
    defaults (depths (3, 3, 9, 3), dims 96-768, patch_t 2, no DropPath)
    over ``batch["asesthetic"]`` [sic], with a VQAHead; ``backbone`` is not
    read, as in the JAX package;
  - ``swin_2d_tiny``: kvq_tpu's ``swin_2d_tiny`` trunk (windows (1, 7, 7))
    with a VQAHead, a key of the port only.

Several keys (``"swin_tiny,conv_tiny"``, DOVER's technical + aesthetic
layout) sum their scores under ``reduce_scores``.  Every head is as wide as
its backbone's ``num_features`` (9472 for ``simpleVQA``);
``head.in_channels`` is ignored, as the JAX package ignores it.

:func:`build_model` is the eval entry point: it builds on ``device`` (CUDA
by default), fills every parameter from a seeded ``torch.Generator`` and
casts to the config's ``compute_dtype``.  :func:`build_train_model` keeps
the master parameters in float32, as flax keeps params f32 under a bf16
``dtype``; a training forward runs on copies in the compute dtype:
:func:`compute_tensors` makes them inside autograd, so that the gradients
reach the f32 masters (the (data, fsdp) step), and the Trainer keeps one
persistent copy a master and carries its gradient over
(``train/trainer.py``).  The tensors that stay float32 (:func:`f32_names`) are not
copied: a BatchNorm's running statistics are the module's own buffers, and
its train-mode update lands there.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn.convnext import ConvNeXt3D
from ..nn.heads import SimpleVQAHead, VQAHead
from ..nn.ksvqe import KSVQE, ksvqe_config
from ..nn.resnet import BatchNorm, FeatureResNet
from ..nn.swin import SWIN_KEYS, SwinTransformer3D, swin_config

# parameters that stay float32 under a bf16 compute dtype, as the JAX
# package keeps them: the position-bias tables (expanded to f32 planes) and
# CONTRIQUE's projector (run in f32); and every tensor of a trainable
# BatchNorm (flax's statistics, scale and bias are float32), see f32_names
_F32_PARAMS = ("position_bias_table", "distortion_tool.projector.")


def compute_dtype(config: dict) -> torch.dtype:
    name = (config.get("model") or {}).get("compute_dtype") or "bfloat16"
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if name not in dtypes:
        raise ValueError(f"unsupported compute_dtype {name!r}")
    return dtypes[name]


def build_backbone(key: str, hypers: dict | None):
    bb = (hypers or {}).get("backbone") or {}
    if key == "KSVQE":
        return KSVQE(ksvqe_config(bb))
    if key in SWIN_KEYS or key == "swin_2d_tiny":
        return SwinTransformer3D(swin_config(key, bb))
    if key == "simpleVQA":
        return FeatureResNet(tuple(bb.get("layers", (3, 4, 6, 3))))
    if key == "conv_tiny":
        return ConvNeXt3D()
    raise NotImplementedError(f"model key {key!r} is not ported yet")


def build_head(key: str, head_cfg: dict | None, in_channels: int):
    """The reference's head of ``key`` (models/model.py:30-71): a
    SimpleVQAHead for ``simpleVQA``, a VQAHead otherwise, ``in_channels``
    wide: the backbone's width.  The config's ``head.in_channels`` is not
    read, as flax infers the width from the input."""
    head_cfg = head_cfg or {}
    if key == "simpleVQA":
        return SimpleVQAHead(in_channels,
                             int(head_cfg.get("hidden_channels", 128)))
    return VQAHead(in_channels=in_channels,
                   hidden_channels=int(head_cfg.get("hidden_channels", 64)))


class VQANetwork(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        args = config["model"]["args"]
        self.key_names = list(args.keys())
        for key, hypers in args.items():
            backbone = build_backbone(key, hypers)
            setattr(self, f"{key}_backbone", backbone)
            setattr(self, f"{key}_head", build_head(
                key, (hypers or {}).get("head"), backbone.num_features))

    def forward(self, inputs: dict[str, Any], reduce_scores: bool = False,
                gen=None):
        """``gen``: the torch.Generator of a training forward's draws (QRS
        noise, DropPath, head dropout, in that order)."""
        scores = []
        dis_contra_loss = None
        for key in self.key_names:
            feat = getattr(self, f"{key}_backbone")(inputs, gen)
            if key == "KSVQE":
                feat, dis_contra_loss = feat
            scores.append(getattr(self, f"{key}_head")(feat, gen))
        if reduce_scores:
            out = scores[0]
            for s in scores[1:]:
                out = out + s
            scores = out
        if dis_contra_loss is not None:
            return scores, dis_contra_loss
        return scores


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Deterministic random weights from one ``torch.Generator``: lecun
    normal for products, truncated normal(0.02) for the position tables,
    identity affine for the norms, zero biases; ConvNeXt's layer scales and
    GRN gains at 1, so that every residual branch counts in the score;
    CLIP's ``logit_scale`` as its module sets it."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("position_bias_table"):
            normal(p, 0.02)
            p.clamp_(-0.04, 0.04)
        elif leaf == "class_embedding":
            normal(p, 0.02)
        elif leaf == "positional_embedding":
            normal(p, 0.01)
        elif leaf in ("a1", "a2", "logit_scale"):
            continue
        elif leaf == "gamma":  # ConvNeXt's layer scale, GRN's gain
            p.fill_(1.0)
        elif p.dim() >= 2:
            normal(p, p[0].numel() ** -0.5)
        elif leaf == "weight":  # norms
            p.fill_(1.0)
        else:
            p.zero_()
    for name, b in model.named_buffers():
        if name.endswith("running_var"):
            b.fill_(1.0)
        elif name.endswith("running_mean"):
            b.zero_()


def f32_names(model: nn.Module) -> set:
    """The names of the parameters and buffers that stay float32 under a
    bf16 compute dtype: those of ``_F32_PARAMS`` and every tensor of a
    trainable :class:`~kvq_tpu_torch.nn.resnet.BatchNorm`."""
    names = {n for n, _ in model.named_parameters()
             if any(k in n for k in _F32_PARAMS)}
    names |= {n for n, _ in model.named_buffers()
              if any(k in n for k in _F32_PARAMS)}
    for mod_name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            names |= {f"{mod_name}.{n}" for n in
                      ("weight", "bias", "running_mean", "running_var")}
    return names


def tensor_compute_dtype(name: str, t: torch.Tensor, dtype: torch.dtype,
                         keep: set) -> torch.dtype:
    """The dtype of the tensor ``name`` in a forward of compute dtype
    ``dtype``: its own when it is not floating point or is in ``keep``."""
    if not t.is_floating_point() or name in keep:
        return t.dtype
    return dtype


def compute_tensors(model: nn.Module, dtype: torch.dtype,
                    keep: set | None = None) -> dict:
    """name -> the parameter or buffer in the compute dtype, those of
    :func:`f32_names` kept float32 (the casts of ``cast_model``, made out
    of place and differentiable; a tensor already in its dtype is passed
    as it is), for ``torch.func.functional_call``.  ``keep``:
    :func:`f32_names` of ``model``, when the caller holds it."""
    keep = f32_names(model) if keep is None else keep
    out = {}
    for name, t in (*model.named_parameters(), *model.named_buffers()):
        out[name] = t.to(tensor_compute_dtype(name, t, dtype, keep))
    return out


def cast_model(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast to the compute dtype, keeping the tensors of :func:`f32_names`
    in float32."""
    keep = f32_names(model)
    model.to(dtype)
    for name, p in model.named_parameters():
        if name in keep:
            p.data = p.data.float()
    for name, b in model.named_buffers():
        if name in keep and b.is_floating_point():
            b.data = b.data.float()
    return model


def build_model(config: dict, device="cuda", seed: int = 0,
                state_dict: dict | None = None) -> VQANetwork:
    """The eval network on ``device``: seeded random weights, or
    ``state_dict`` (reference checkpoint names) when given."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = VQANetwork(config)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        init_weights(model, seed)
    return cast_model(model, compute_dtype(config)).eval()


def build_train_model(config: dict, device="cuda",
                      seed: int = 0) -> VQANetwork:
    """The network for training on ``device``: seeded random float32
    master parameters, in train mode."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = VQANetwork(config)
    init_weights(model, seed)
    return model.train()
