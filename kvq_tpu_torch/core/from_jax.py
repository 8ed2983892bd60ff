"""Weights carried across from the JAX package.

:func:`state_dict_from_jax` takes the JAX package's ``params`` and
``batch_stats`` trees of a ``VQANetwork`` (nested dicts of arrays under
flax names: ``<key>_backbone/...``, ``<key>_head/...``) for the KSVQE key,
the Swin-T-3D keys and ``simpleVQA``, and returns the port's
``state_dict``, whose names are the PyTorch reference checkpoint's — the
names ``kvq_tpu/core/torch_import.py`` reads (``convert_ksvqe_full``;
``convert_swin3d`` for a Swin trunk, whose stages the JAX tree keeps under
``trunk``; ``convert_simplevqa_full`` for SimpleVQA's ResNet-50 trunk and
its ``fc1``/``fc2`` head; upstream ConvNeXt's names for ``conv_tiny``).
:func:`map_slowfast_tree` does the same for a ``SlowFastR50`` tree
(``convert_slowfast_r50``, pytorchvideo's names), :func:`map_convnext_tree`
for a ConvNeXt, :func:`map_head_tree` for each head of kvq_tpu/nn/heads.py
and :func:`map_clip_tree` for the full CLIP (``convert_clip_full``,
OpenAI's names).  Each is the converter's inverse:

  - Dense kernel (in, out)        -> Linear weight (out, in)
  - Conv kernel HWIO / DHWIO      -> OIHW / OIDHW
  - LayerNorm scale/bias          -> weight/bias
  - BatchNorm scale/bias + stats  -> weight/bias, running_mean/var

A tree may be partial: what it lacks is left out of the result, and the
leaves that map to no port name are returned by :func:`map_jax_tree`,
whose report ``load_weights`` prints as ``kvq_tpu.core.checkpoint.
merge_params`` does.  Each layout change is elementwise-safe (transpose,
reshape), so an optimizer moment tree (optax's ``mu``/``nu``, shaped like
``params``) maps the same way; :func:`adamw_state_from_jax` does that for
the JAX trainer's optax state.  :func:`jax_axes` gives, for a parameter of
a port module, where each axis of its JAX array lies in the port's tensor
(the layouts above, read from the module that holds it).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def _np(a) -> np.ndarray:
    """A leaf as float32 numpy (a bfloat16 leaf is a torch tensor)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(a, dtype=np.float32)


class _Tree:
    """A read-only view of a JAX (sub)tree that notes the path of each leaf
    read into ``used``.  A missing key gives an empty tree, so a partial
    tree maps what it has; an empty map where a leaf belongs (optax's
    masked node) is not a leaf."""

    def __init__(self, node, path: tuple = (), used: set | None = None):
        self.node = node if isinstance(node, Mapping) else {}
        self.path = path
        self.used = set() if used is None else used

    def __getitem__(self, key):
        value = self.node.get(key)
        if isinstance(value, Mapping) or value is None:
            return _Tree(value, self.path + (key,), self.used)
        self.used.add(self.path + (key,))
        return value

    def __contains__(self, key) -> bool:
        return key in self.node

    def __iter__(self):
        return iter(self.node)


def _leaves(tree, path=()):
    """The ``/``-joined paths of every leaf (non-empty-map entry) of a
    nested map."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path


class _Out:
    def __init__(self):
        self.sd: dict[str, torch.Tensor] = {}

    def put(self, name: str, value, layout=None) -> None:
        """``sd[name] = layout(value)``; nothing when ``value`` is absent."""
        if isinstance(value, _Tree):
            return
        a = _np(value)
        a = layout(a) if layout else a
        # ascontiguousarray makes a 0-d array 1-d; the reshape keeps ()
        self.sd[name] = torch.from_numpy(
            np.ascontiguousarray(a).reshape(a.shape))

    def dense(self, name: str, p, bias: bool = True) -> None:
        self.put(f"{name}.weight", p["kernel"], np.transpose)
        if bias and "bias" in p:
            self.put(f"{name}.bias", p["bias"])

    def conv1x1(self, name: str, p, nd: int) -> None:
        self.put(f"{name}.weight", p["kernel"],
                 lambda k: k.T.reshape(k.T.shape + (1,) * nd))  # (out, in)
        self.put(f"{name}.bias", p["bias"])

    def ln(self, name: str, p) -> None:
        self.put(f"{name}.weight", p["scale"])
        self.put(f"{name}.bias", p["bias"])

    def bn(self, name: str, p, s) -> None:
        self.put(f"{name}.weight", p["scale"])
        self.put(f"{name}.bias", p["bias"])
        self.put(f"{name}.running_mean", s["mean"])
        self.put(f"{name}.running_var", s["var"])
        if f"{name}.running_mean" in self.sd:
            self.sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    def adapter(self, name: str, p) -> None:
        self.dense(f"{name}.0", p["fc1"])
        self.dense(f"{name}.2", p["fc2"])


def _indexed(tree, prefix: str) -> list[int]:
    return sorted(int(k[len(prefix):]) for k in tree
                  if k.startswith(prefix) and k[len(prefix):].isdigit())


def _swin(o: _Out, pre: str, p: _Tree, layers: _Tree) -> None:
    """Patch embed and final norm from ``p``, the stages from ``layers``."""
    o.put(f"{pre}patch_embed.proj.weight", p["patch_embed"]["proj"]["kernel"],
          lambda k: k.transpose(4, 3, 0, 1, 2))  # (pt, ph, pw, C, F)
    o.put(f"{pre}patch_embed.proj.bias", p["patch_embed"]["proj"]["bias"])
    o.ln(f"{pre}patch_embed.norm", p["patch_embed"]["norm"])
    for li in _indexed(layers, "layers_"):
        lp = layers[f"layers_{li}"]
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


def _clip(o: _Out, pre: str, p: _Tree) -> None:
    v = f"{pre}visual."
    o.put(f"{v}conv1.weight", p["conv1"]["kernel"],
          lambda k: k.transpose(3, 2, 0, 1))
    o.put(f"{v}class_embedding", p["class_embedding"])
    o.put(f"{v}positional_embedding", p["positional_embedding"])
    o.ln(f"{v}ln_pre", p["ln_pre"])
    _attn_blocks(o, f"{v}transformer.resblocks.", p)
    for i in _indexed(p, "adapter_layer_"):
        o.adapter(f"{pre}adapter_layer.{i}", p[f"adapter_layer_{i}"])


def _conv2d(o: _Out, name: str, p) -> None:
    o.put(name, p["kernel"], lambda k: k.transpose(3, 2, 0, 1))  # HWIO


def _conv3d(o: _Out, name: str, p) -> None:
    o.put(name, p["kernel"], lambda k: k.transpose(4, 3, 0, 1, 2))  # DHWIO


def _resnet(o: _Out, p: _Tree, s: _Tree, stem: tuple[str, str],
            stage_prefix) -> None:
    """A JAX ResNetTrunk (``stem``, ``layer{i}_{b}``): the stem's conv and
    BatchNorm to the names ``stem``, block ``b`` of stage ``i`` under
    ``stage_prefix(i)``."""
    _conv2d(o, f"{stem[0]}.weight", p["stem"]["conv1"])
    o.bn(stem[1], p["stem"]["bn1"], s["stem"]["bn1"])
    for name in p:
        if not name.startswith("layer"):
            continue
        stage, blk = name[len("layer"):].split("_")
        dst = f"{stage_prefix(int(stage))}.{blk}"
        bp, bs = p[name], s[name]
        for ci in (1, 2, 3):  # a BasicBlock has no conv3: nothing is put
            _conv2d(o, f"{dst}.conv{ci}.weight", bp[f"conv{ci}"])
            o.bn(f"{dst}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
        if "downsample_conv" in bp:
            _conv2d(o, f"{dst}.downsample.0.weight", bp["downsample_conv"])
            o.bn(f"{dst}.downsample.1", bp["downsample_bn"],
                 bs["downsample_bn"])


def _contrique(o: _Out, pre: str, p: _Tree, s: _Tree) -> None:
    e = f"{pre}encoder."
    _resnet(o, p["encoder"], s["encoder"], (f"{e}0", f"{e}1"),
            lambda stage: f"{e}{3 + stage}")
    o.dense(f"{pre}projector.0", p["projector_fc1"], bias=False)
    o.bn(f"{pre}projector.1", p["projector_bn1"], s["projector_bn1"])
    o.dense(f"{pre}projector.3", p["projector_fc2"], bias=False)
    o.bn(f"{pre}projector.4", p["projector_bn2"], s["projector_bn2"])


def _ksvqe(o: _Out, pre: str, p: _Tree, s: _Tree) -> None:
    _swin(o, pre, p, p)
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


def _convnext(o: _Out, pre: str, p: _Tree) -> None:
    """A JAX ConvNeXt3D tree (``stem_conv``, ``stem_norm``,
    ``down_norm_{i}``, ``down_conv_{i}``, ``stage{i}_block{j}``, ``norm``)
    under upstream ConvNeXt's names."""
    d = f"{pre}downsample_layers."
    _conv3d(o, f"{d}0.0.weight", p["stem_conv"])
    o.put(f"{d}0.0.bias", p["stem_conv"]["bias"])
    o.ln(f"{d}0.1", p["stem_norm"])
    for i in _indexed(p, "down_norm_"):
        o.ln(f"{d}{i}.0", p[f"down_norm_{i}"])
        _conv3d(o, f"{d}{i}.1.weight", p[f"down_conv_{i}"])
        o.put(f"{d}{i}.1.bias", p[f"down_conv_{i}"]["bias"])
    for name in p:
        if not name.startswith("stage"):
            continue
        stage, blk = name[len("stage"):].split("_block")
        bp, dst = p[name], f"{pre}stages.{stage}.{blk}"
        _conv3d(o, f"{dst}.dwconv.weight", bp["dwconv"])  # (k, 7, 7, 1, C)
        o.put(f"{dst}.dwconv.bias", bp["dwconv"]["bias"])
        o.ln(f"{dst}.norm", bp["norm"])
        o.dense(f"{dst}.pwconv1", bp["pwconv1"])
        o.dense(f"{dst}.pwconv2", bp["pwconv2"])
        o.put(f"{dst}.gamma", bp["gamma"])
        o.put(f"{dst}.grn.gamma", bp["grn"]["gamma"])
        o.put(f"{dst}.grn.beta", bp["grn"]["beta"])
    o.ln(f"{pre}norm", p["norm"])


def _head(o: _Out, pre: str, kind: str, p: _Tree) -> None:
    """A JAX head of class ``kind`` (kvq_tpu/nn/heads.py) under the port's
    names."""
    if kind == "VQAHead":
        o.conv1x1(f"{pre}fc_hid", p["fc_hid"], 3)
        o.conv1x1(f"{pre}fc_last", p["fc_last"], 3)
    elif kind == "SimpleVQAHead":
        o.dense(f"{pre}quality.0", p["fc1"])
        o.dense(f"{pre}quality.1", p["fc2"])
    elif kind == "IQAHead":
        o.dense(f"{pre}fc_hid", p["fc_hid"])
        o.dense(f"{pre}fc_last", p["fc_last"])
    elif kind == "VARHead":
        o.conv1x1(f"{pre}fc", p["fc"], 3)
    elif kind == "MaxVQAHead":
        o.conv1x1(f"{pre}fc_hid", p["fc_hid"], 3)
        o.put(f"{pre}fc_last.weight", p["fc_last_kernel"],
              lambda k: k.reshape(k.shape + (1, 1, 1)))  # (out_dims, hidden)
        o.put(f"{pre}fc_last.bias", p["fc_last_bias"])
    else:
        raise ValueError(f"unknown head {kind!r}")


def _attn_blocks(o: _Out, pre: str, p: _Tree) -> None:
    """``resblocks_{i}`` of a JAX CLIP transformer -> ``{pre}{i}``."""
    for i in _indexed(p, "resblocks_"):
        bp, dst = p[f"resblocks_{i}"], f"{pre}{i}"
        o.put(f"{dst}.attn.in_proj_weight", bp["attn"]["in_proj"]["kernel"],
              np.transpose)
        o.put(f"{dst}.attn.in_proj_bias", bp["attn"]["in_proj"]["bias"])
        o.dense(f"{dst}.attn.out_proj", bp["attn"]["out_proj"])
        o.ln(f"{dst}.ln_1", bp["ln_1"])
        o.ln(f"{dst}.ln_2", bp["ln_2"])
        o.dense(f"{dst}.mlp.c_fc", bp["mlp_c_fc"])
        o.dense(f"{dst}.mlp.c_proj", bp["mlp_c_proj"])


def _clip_full(o: _Out, p: _Tree, s: _Tree) -> None:
    """A JAX ``CLIP`` tree (kvq_tpu/nn/clip_model.py) under OpenAI's
    names: either visual tower, the text encoder, ``logit_scale``."""
    v, vs = p["visual"], s["visual"]
    if "attnpool" in v:  # ModifiedResNet
        for ci in (1, 2, 3):
            _conv2d(o, f"visual.conv{ci}.weight", v[f"stem_conv{ci}"])
            o.bn(f"visual.bn{ci}", v[f"stem_bn{ci}"], vs[f"stem_bn{ci}"])
        for name in v:
            if not name.startswith("layer"):
                continue
            stage, blk = name[len("layer"):].split("_")
            bp, bs, dst = v[name], vs[name], f"visual.layer{stage}.{blk}"
            for ci in (1, 2, 3):
                _conv2d(o, f"{dst}.conv{ci}.weight", bp[f"conv{ci}"])
                o.bn(f"{dst}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
            _conv2d(o, f"{dst}.downsample.0.weight", bp["downsample_conv"])
            o.bn(f"{dst}.downsample.1", bp["downsample_bn"],
                 bs["downsample_bn"])
        ap = v["attnpool"]
        o.put("visual.attnpool.positional_embedding",
              ap["positional_embedding"])
        for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
            o.dense(f"visual.attnpool.{proj}", ap[proj])
    else:  # the ViT tower
        _clip(o, "", v)
        o.ln("visual.ln_post", p["visual_ln_post"])
        o.put("visual.proj", p["visual_proj"])
    t = p["text"]
    o.put("token_embedding.weight", t["token_embedding"])
    o.put("positional_embedding", t["positional_embedding"])
    _attn_blocks(o, "transformer.resblocks.", t)
    o.ln("ln_final", t["ln_final"])
    o.put("text_projection", t["text_projection"])
    o.put("logit_scale", p["logit_scale"], lambda a: a.reshape(()))


def _unread(params: Mapping, batch_stats: Mapping | None, used: set
            ) -> list[str]:
    return ["/".join(path) for tree, pre in (
        (params, ()), (batch_stats or {}, ("batch_stats",)))
        for path in _leaves(tree, pre) if path not in used]


def map_jax_tree(params: Mapping, batch_stats: Mapping | None = None
                 ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """JAX VQANetwork trees (KSVQE, Swin-T-3D and simpleVQA keys, whole or
    partial) -> (the port's state_dict of what they hold, the
    ``/``-joined paths of the leaves that map to no port name).  A backbone
    of a key that is not ported raises ``NotImplementedError``."""
    used: set = set()
    p, s = _Tree(params, (), used), _Tree(batch_stats, ("batch_stats",), used)
    o = _Out()
    for name in p:
        key, _, part = name.rpartition("_")
        tree = p[name]
        if part == "head":
            _head(o, f"{name}.", "SimpleVQAHead" if key == "simpleVQA"
                  else "VQAHead", tree)
        elif name == "KSVQE_backbone":
            _ksvqe(o, f"{name}.", tree, s[name])
        elif name == "simpleVQA_backbone":
            _resnet(o, tree["trunk"], s[name]["trunk"],
                    (f"{name}.conv1", f"{name}.bn1"),
                    lambda stage: f"{name}.layer{stage}")
        elif part == "backbone" and "stem_conv" in tree:  # conv_tiny
            _convnext(o, f"{name}.", tree)
        elif part == "backbone" and "trunk" in tree:  # a Swin key
            _swin(o, f"{name}.", tree, tree["trunk"])
        elif part == "backbone":
            raise NotImplementedError(f"model key {key!r} is not ported yet")
    return o.sd, _unread(params, batch_stats, used)


def map_slowfast_tree(params: Mapping, batch_stats: Mapping | None = None
                      ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """A JAX ``SlowFastR50`` tree (kvq_tpu/nn/slowfast.py: ``slow`` /
    ``fast`` pathways of ``stem_conv``, ``stem_bn`` and ``res{i}_{b}``
    blocks, ``lateral_{i}_conv`` / ``_bn`` fusions), whole or partial ->
    (the state_dict of :class:`~kvq_tpu_torch.nn.slowfast.SlowFastR50`
    under pytorchvideo's names, the unread leaves)."""
    used: set = set()
    p, s = _Tree(params, (), used), _Tree(batch_stats, ("batch_stats",), used)
    o = _Out()
    for pi, path in ((0, "slow"), (1, "fast")):
        pp, ps = p[path], s[path]
        stem = f"blocks.0.multipathway_blocks.{pi}"
        _conv3d(o, f"{stem}.conv.weight", pp["stem_conv"])
        o.bn(f"{stem}.norm", pp["stem_bn"], ps["stem_bn"])
        for name in pp:
            if not name.startswith("res"):
                continue
            stage, blk = name[len("res"):].split("_")
            dst = (f"blocks.{int(stage) - 1}.multipathway_blocks.{pi}"
                   f".res_blocks.{blk}")
            bp, bs = pp[name], ps[name]
            for ci, tc in ((1, "a"), (2, "b"), (3, "c")):
                _conv3d(o, f"{dst}.branch2.conv_{tc}.weight", bp[f"conv{ci}"])
                o.bn(f"{dst}.branch2.norm_{tc}", bp[f"bn{ci}"], bs[f"bn{ci}"])
            _conv3d(o, f"{dst}.branch1_conv.weight", bp["downsample_conv"])
            o.bn(f"{dst}.branch1_norm", bp["downsample_bn"],
                 bs["downsample_bn"])
    for name in p:
        if name.startswith("lateral_") and name.endswith("_conv"):
            i = name.split("_")[1]
            dst = f"blocks.{i}.multipathway_fusion"
            _conv3d(o, f"{dst}.conv_fast_to_slow.weight", p[name])
            o.bn(f"{dst}.norm", p[f"lateral_{i}_bn"], s[f"lateral_{i}_bn"])
    return o.sd, _unread(params, batch_stats, used)


def state_dict_from_jax(params: Mapping, batch_stats: Mapping | None = None
                        ) -> dict[str, torch.Tensor]:
    """JAX VQANetwork trees (every ported key) -> the port's state_dict."""
    return map_jax_tree(params, batch_stats)[0]


def _mapped(fill, params, batch_stats=None):
    used: set = set()
    o = _Out()
    fill(o, _Tree(params, (), used), _Tree(batch_stats, ("batch_stats",),
                                            used))
    return o.sd, _unread(params, batch_stats, used)


def map_convnext_tree(params: Mapping) -> tuple[dict, list[str]]:
    """A JAX ``ConvNeXt3D`` tree, or a ``ConvNeXt2D`` one (under
    ``trunk``) -> (the state_dict of the port's module, the unread
    leaves)."""
    if "trunk" in params:
        return _mapped(lambda o, p, s: _convnext(o, "trunk.", p["trunk"]),
                       params)
    return _mapped(lambda o, p, s: _convnext(o, "", p), params)


def map_head_tree(kind: str, params: Mapping) -> tuple[dict, list[str]]:
    """A JAX head of class ``kind`` (``VQAHead``, ``SimpleVQAHead``,
    ``IQAHead``, ``VARHead``, ``MaxVQAHead``) -> (the state_dict of the
    port's head, the unread leaves)."""
    return _mapped(lambda o, p, s: _head(o, "", kind, p), params)


def map_clip_tree(params: Mapping, batch_stats: Mapping | None = None
                  ) -> tuple[dict, list[str]]:
    """A JAX ``CLIP`` tree (ModifiedResNet's BatchNorm statistics in
    ``batch_stats``) -> (the state_dict of the port's
    :class:`~kvq_tpu_torch.nn.clip_model.CLIP` under OpenAI's names, the
    unread leaves)."""
    return _mapped(_clip_full, params, batch_stats)


def _expect(node, keys: set, where: str):
    if not isinstance(node, Mapping) or set(node) != keys:
        got = sorted(node) if isinstance(node, Mapping) else type(node).__name__
        raise ValueError(f"opt_state{where}: expected the keys "
                         f"{sorted(keys)}, got {got}")
    return node


def adamw_state_from_jax(opt_state: Mapping, frozen: bool, scaled: bool
                         ) -> tuple[int, dict, dict]:
    """The serialized optax state of the JAX trainer's optimizer
    (kvq_tpu/train/optim.py:69-111) -> ``(count, exp_avg, exp_avg_sq)``, the
    moments as state_dicts under the port's parameter names.

    The chain is ``adamw`` alone, or ``chain(masked(adamw),
    masked(set_to_zero))`` under the frozen mask (``frozen``), with
    ``masked(scale)`` appended when ``backbone_lr_mult != 1`` (``scaled``).
    ``adamw`` is ``(ScaleByAdamState(count, mu, nu), EmptyState,
    ScaleByScheduleState(count))``; the leaves the mask leaves out are
    empty maps and map to nothing.  A state of another shape raises
    ``ValueError``."""
    if frozen or scaled:
        n = 1 + frozen + scaled
        chain = _expect(opt_state, {str(i) for i in range(n)}, "")
        adamw = chain["0"]
        if frozen:
            adamw = _expect(adamw, {"inner_state"}, "/0")["inner_state"]
        for i in range(1, n):
            masked = _expect(chain[str(i)], {"inner_state"}, f"/{i}")
            _expect(masked["inner_state"], set(), f"/{i}/inner_state")
    else:
        adamw = opt_state
    _expect(adamw, {"0", "1", "2"}, " (adamw)")
    adam = _expect(adamw["0"], {"count", "mu", "nu"}, " (adamw/0)")
    _expect(adamw["1"], set(), " (adamw/1)")
    sched = _expect(adamw["2"], {"count"}, " (adamw/2)")
    count = int(np.asarray(adam["count"]))
    if int(np.asarray(sched["count"])) != count:
        raise ValueError("opt_state: the adam and schedule counts differ")
    mu, unread_mu = map_jax_tree(adam["mu"])
    nu, unread_nu = map_jax_tree(adam["nu"])
    if unread_mu or unread_nu or mu.keys() != nu.keys():
        raise ValueError(f"opt_state: moments that map to no parameter: "
                         f"{(unread_mu + unread_nu)[:5]}")
    return count, mu, nu


def jax_axes(module: nn.Module, name: str) -> tuple[int, ...]:
    """The port axis of each axis of the JAX array behind ``module``'s
    parameter ``name``: JAX's shape is ``tuple(port_shape[a] for a in
    jax_axes(...))``.  A Linear weight and an ``in_proj_weight`` are JAX's
    (in, out) kernel transposed; a conv weight (O, I, *k) is JAX's (*k, I,
    O) kernel, also where JAX holds a 1x1(x1) conv as a Dense (in, out):
    the axes of size 1 aside, the order is the same.  Every other
    parameter has JAX's layout."""
    owner, _, leaf = name.rpartition(".")
    sub = module.get_submodule(owner) if owner else module
    ndim = getattr(sub, leaf).dim()
    if leaf == "in_proj_weight" or (
            leaf == "weight" and isinstance(sub, nn.Linear)):
        return (1, 0)
    if leaf == "weight" and isinstance(sub, nn.modules.conv._ConvNd):
        return tuple(range(2, ndim)) + (1, 0)
    return tuple(range(ndim))
