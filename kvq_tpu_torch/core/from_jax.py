"""Weights carried across from the JAX package.

:func:`state_dict_from_jax` takes the JAX package's ``params`` and
``batch_stats`` trees of a ``VQANetwork`` (nested dicts of numpy arrays
under flax names: ``<key>_backbone/...``, ``<key>_head/...``) for the KSVQE
key and the Swin-T-3D keys, and returns the port's ``state_dict``, whose
names are the PyTorch reference checkpoint's — the names
``kvq_tpu/core/torch_import.py`` reads (``convert_ksvqe_full``;
``convert_swin3d`` for a Swin trunk, whose stages the JAX tree keeps under
``trunk``).  It is that converter's inverse:

  - Dense kernel (in, out)        -> Linear weight (out, in)
  - Conv kernel HWIO / DHWIO      -> OIHW / OIDHW
  - LayerNorm scale/bias          -> weight/bias
  - BatchNorm scale/bias + stats  -> weight/bias, running_mean/var
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _Out:
    def __init__(self):
        self.sd: dict[str, torch.Tensor] = {}

    def put(self, name: str, value) -> None:
        self.sd[name] = value if isinstance(value, torch.Tensor) else _t(value)

    def dense(self, name: str, p: Mapping, bias: bool = True) -> None:
        self.put(f"{name}.weight", np.asarray(p["kernel"]).T)
        if bias and "bias" in p:
            self.put(f"{name}.bias", p["bias"])

    def conv1x1(self, name: str, p: Mapping, nd: int) -> None:
        k = np.asarray(p["kernel"]).T  # (out, in)
        self.put(f"{name}.weight", k.reshape(k.shape + (1,) * nd))
        self.put(f"{name}.bias", p["bias"])

    def ln(self, name: str, p: Mapping) -> None:
        self.put(f"{name}.weight", p["scale"])
        self.put(f"{name}.bias", p["bias"])

    def bn(self, name: str, p: Mapping, s: Mapping) -> None:
        self.put(f"{name}.weight", p["scale"])
        self.put(f"{name}.bias", p["bias"])
        self.put(f"{name}.running_mean", s["mean"])
        self.put(f"{name}.running_var", s["var"])
        self.put(f"{name}.num_batches_tracked", torch.tensor(0))

    def adapter(self, name: str, p: Mapping) -> None:
        self.dense(f"{name}.0", p["fc1"])
        self.dense(f"{name}.2", p["fc2"])


def _indexed(tree: Mapping, prefix: str) -> list[int]:
    return sorted(int(k[len(prefix):]) for k in tree
                  if k.startswith(prefix) and k[len(prefix):].isdigit())


def _swin(o: _Out, pre: str, p: Mapping) -> None:
    k = np.asarray(p["patch_embed"]["proj"]["kernel"])  # (pt, ph, pw, C, F)
    o.put(f"{pre}patch_embed.proj.weight", k.transpose(4, 3, 0, 1, 2))
    o.put(f"{pre}patch_embed.proj.bias", p["patch_embed"]["proj"]["bias"])
    o.ln(f"{pre}patch_embed.norm", p["patch_embed"]["norm"])
    for li in _indexed(p, "layers_"):
        lp = p[f"layers_{li}"]
        for b in _indexed(lp, "blocks_"):
            bp = lp[f"blocks_{b}"]
            dst = f"{pre}layers.{li}.blocks.{b}"
            o.ln(f"{dst}.norm1", bp["norm1"])
            o.ln(f"{dst}.norm2", bp["norm2"])
            o.dense(f"{dst}.attn.qkv", bp["attn"]["qkv"])
            o.dense(f"{dst}.attn.proj", bp["attn"]["proj"])
            for tab in ("relative_position_bias_table",
                        "fragment_position_bias_table"):
                if tab in bp["attn"]:
                    o.put(f"{dst}.attn.{tab}", bp["attn"][tab])
            o.dense(f"{dst}.mlp.fc1", bp["mlp"]["fc1"])
            o.dense(f"{dst}.mlp.fc2", bp["mlp"]["fc2"])
        if "downsample" in lp:
            o.ln(f"{pre}layers.{li}.downsample.norm", lp["downsample"]["norm"])
            o.dense(f"{pre}layers.{li}.downsample.reduction",
                    lp["downsample"]["reduction"], bias=False)
    o.ln(f"{pre}norm", p["norm"])


def _clip(o: _Out, pre: str, p: Mapping) -> None:
    v = f"{pre}visual."
    o.put(f"{v}conv1.weight",
          np.asarray(p["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    o.put(f"{v}class_embedding", p["class_embedding"])
    o.put(f"{v}positional_embedding", p["positional_embedding"])
    o.ln(f"{v}ln_pre", p["ln_pre"])
    for i in _indexed(p, "resblocks_"):
        bp = p[f"resblocks_{i}"]
        dst = f"{v}transformer.resblocks.{i}"
        o.put(f"{dst}.attn.in_proj_weight",
              np.asarray(bp["attn"]["in_proj"]["kernel"]).T)
        o.put(f"{dst}.attn.in_proj_bias", bp["attn"]["in_proj"]["bias"])
        o.dense(f"{dst}.attn.out_proj", bp["attn"]["out_proj"])
        o.ln(f"{dst}.ln_1", bp["ln_1"])
        o.ln(f"{dst}.ln_2", bp["ln_2"])
        o.dense(f"{dst}.mlp.c_fc", bp["mlp_c_fc"])
        o.dense(f"{dst}.mlp.c_proj", bp["mlp_c_proj"])
    for i in _indexed(p, "adapter_layer_"):
        o.adapter(f"{pre}adapter_layer.{i}", p[f"adapter_layer_{i}"])


def _contrique(o: _Out, pre: str, p: Mapping, s: Mapping) -> None:
    enc, encs = p["encoder"], s["encoder"]
    e = f"{pre}encoder."

    def conv(name, cp):
        o.put(name, np.asarray(cp["kernel"]).transpose(3, 2, 0, 1))

    conv(f"{e}0.weight", enc["stem"]["conv1"])
    o.bn(f"{e}1", enc["stem"]["bn1"], encs["stem"]["bn1"])
    for name in enc:
        if not name.startswith("layer"):
            continue
        stage, blk = name[len("layer"):].split("_")
        dst = f"{e}{3 + int(stage)}.{blk}"
        bp, bs = enc[name], encs[name]
        for ci in (1, 2, 3):
            conv(f"{dst}.conv{ci}.weight", bp[f"conv{ci}"])
            o.bn(f"{dst}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
        if "downsample_conv" in bp:
            conv(f"{dst}.downsample.0.weight", bp["downsample_conv"])
            o.bn(f"{dst}.downsample.1", bp["downsample_bn"],
                 bs["downsample_bn"])
    o.dense(f"{pre}projector.0", p["projector_fc1"], bias=False)
    o.bn(f"{pre}projector.1", p["projector_bn1"], s["projector_bn1"])
    o.dense(f"{pre}projector.3", p["projector_fc2"], bias=False)
    o.bn(f"{pre}projector.4", p["projector_bn2"], s["projector_bn2"])


def _ksvqe(o: _Out, pre: str, p: Mapping, s: Mapping) -> None:
    _swin(o, pre, p)
    _clip(o, f"{pre}CLIP_tool.", p["CLIP_tool"])
    _contrique(o, f"{pre}distortion_tool.", p["distortion_tool"],
               s["distortion_tool"])
    o.adapter(f"{pre}dist_adapter", p["dist_adapter"])
    for m in _indexed(p, "semantic_adapter_"):
        o.adapter(f"{pre}semantic_adapter.{m}", p[f"semantic_adapter_{m}"])
        o.adapter(f"{pre}distortion_adapter.{m}", p[f"distortion_adapter_{m}"])
        for which in ("semantic_cross", "distortion_cross"):
            for fc in ("fc_q", "fc_k", "fc_v"):
                o.dense(f"{pre}{which}.{m}.{fc}", p[f"{which}_{m}"][fc])
        ds = p[f"distortion_self_{m}"]
        o.dense(f"{pre}distortion_self.{m}.to_qkv", ds["to_qkv"], bias=False)
        o.dense(f"{pre}distortion_self.{m}.to_out.0", ds["to_out"])
        for conv in ("conv_gama", "conv_beta"):
            o.conv1x1(f"{pre}semantic_mod.{m}.{conv}",
                      p[f"semantic_mod_{m}"][conv], 2)
        for lin in ("get_gamma", "get_beta"):
            o.dense(f"{pre}distortion_mod.{m}.{lin}",
                    p[f"distortion_mod_{m}"][lin])
    o.put(f"{pre}a1", p["a1"])
    o.put(f"{pre}a2", p["a2"])


def state_dict_from_jax(params: Mapping, batch_stats: Mapping | None = None
                        ) -> dict[str, torch.Tensor]:
    """JAX VQANetwork trees (KSVQE and Swin-T-3D keys) -> the port's
    state_dict."""
    batch_stats = batch_stats or {}
    o = _Out()
    for name, tree in params.items():
        key, _, part = name.rpartition("_")
        if part == "head":
            o.conv1x1(f"{name}.fc_hid", tree["fc_hid"], 3)
            o.conv1x1(f"{name}.fc_last", tree["fc_last"], 3)
        elif name == "KSVQE_backbone":
            _ksvqe(o, f"{name}.", tree, batch_stats.get(name, {}))
        elif part == "backbone" and "trunk" in tree:  # a Swin-T-3D key
            stages = {k: v for k, v in tree.items() if k != "trunk"}
            _swin(o, f"{name}.", {**stages, **tree["trunk"]})
        else:
            raise NotImplementedError(f"model key {key!r} is not ported yet")
    return o.sd
