"""Model composition — the counterpart of kvq_tpu/models/vqa_network.py and
of the reference ``VQA_Network`` (models/model.py:18-121): one
``<key>_backbone`` + ``<key>_head`` per key of ``config['model']['args']``.
Ported keys: ``KSVQE`` and the Swin-T-3D keys ``swin_tiny``,
``swin_tiny_grpb`` (FAST-VQA), ``swin_tiny_grpb_m`` and ``swin_small``, each
with a VQAHead; ``conv_tiny`` and ``simpleVQA`` are not ported yet.

:func:`build_model` is the eval entry point: it builds on ``device`` (CUDA
by default), fills every parameter from a seeded ``torch.Generator`` and
casts to the config's ``compute_dtype``.  :func:`build_train_model` keeps
the master parameters in float32, as flax keeps params f32 under a bf16
``dtype``; a training forward runs on :func:`compute_tensors`, copies in the
compute dtype made inside autograd, so that the gradients reach the f32
masters.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn.heads import VQAHead
from ..nn.ksvqe import KSVQE, ksvqe_config
from ..nn.swin import SWIN_KEYS, SwinTransformer3D, swin_config

# parameters that stay float32 under a bf16 compute dtype, as the JAX
# package keeps them: the position-bias tables (expanded to f32 planes) and
# CONTRIQUE's projector (run in f32)
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
    if key in SWIN_KEYS:
        return SwinTransformer3D(swin_config(key, bb))
    raise NotImplementedError(f"model key {key!r} is not ported yet")


class VQANetwork(nn.Module):
    def __init__(self, config: dict):
        super().__init__()
        args = config["model"]["args"]
        self.key_names = list(args.keys())
        for key, hypers in args.items():
            backbone = build_backbone(key, hypers)
            head_cfg = (hypers or {}).get("head") or {}
            setattr(self, f"{key}_backbone", backbone)
            setattr(self, f"{key}_head", VQAHead(
                in_channels=backbone.num_features,
                hidden_channels=int(head_cfg.get("hidden_channels", 64)),
            ))

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
    identity affine for the norms, zero biases."""
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
        elif leaf in ("a1", "a2"):
            continue
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


def _compute_dtype_of(name: str, t: torch.Tensor, dtype: torch.dtype):
    if not t.is_floating_point() or any(k in name for k in _F32_PARAMS):
        return t.dtype
    return dtype


def compute_tensors(model: nn.Module, dtype: torch.dtype,
                    trainable_only: bool = False) -> dict:
    """name -> the parameter or buffer in the compute dtype, the
    ``_F32_PARAMS`` kept float32 (the casts of ``cast_model``, made out of
    place and differentiable), for ``torch.func.functional_call``.  With
    ``trainable_only``, only the parameters that require a gradient."""
    out = {}
    for name, p in model.named_parameters():
        if p.requires_grad or not trainable_only:
            out[name] = p.to(_compute_dtype_of(name, p, dtype))
    if not trainable_only:
        for name, b in model.named_buffers():
            out[name] = b.to(_compute_dtype_of(name, b, dtype))
    return out


def cast_model(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast to the compute dtype, keeping the float32 parameters of
    ``_F32_PARAMS`` in float32."""
    model.to(dtype)
    for name, p in model.named_parameters():
        if any(k in name for k in _F32_PARAMS):
            p.data = p.data.float()
    for name, b in model.named_buffers():
        if any(k in name for k in _F32_PARAMS) and b.is_floating_point():
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
