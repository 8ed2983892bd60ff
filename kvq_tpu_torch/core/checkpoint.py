"""Checkpoints of the port, and the JAX package's.

Full train state (counterpart of the JAX trainer's save_full_state /
load_full_state, kvq_tpu/train/trainer.py:279-332): parameters, optimizer
and schedule state, EMA parameters, step and best metrics, in one
``torch.save`` file.  ``Trainer.load`` also resumes a JAX
``_last_state.msgpack`` (train/trainer.py).

:func:`load_checkpoint` reads either kind and tells them apart by their
first bytes, not their names (the JAX docs name converted files
``.ckpt``): a ``torch.save`` file, or a flax msgpack file, which
core/msgpack_io.py decodes without flax.

Weights for ``load_path`` / ``test_load_path`` (counterpart of
kvq_tpu/core/checkpoint.py:merge_params and of the reference LSVQ loader's
table fork, kvq_tpu/core/torch_import.py:convert_swin3d):
:func:`merge_state_dict` grafts a ``state_dict`` onto a module with the
reference's ``load_state_dict(strict=False)`` semantics.  The port keeps
the reference's parameter names, so a reference ``.pth`` ``state_dict``
loads as it is.  A JAX file (``kvq_tpu.cli.convert``'s ``{"params",
"batch_stats"}``, a ``*_finetuned.msgpack`` best-weights file, or a full
state, of which only ``params`` and ``batch_stats`` are taken) goes through
core/from_jax.py first, whole or partial.  A timm Swin-T state dict
(``swin_tiny_patch4_window7_224``, either timm generation) is normalised
for ``swin_2d_tiny`` first (:func:`timm_swin2d_state_dict`, the
normalisations of kvq_tpu/core/torch_import.py:254-303).
"""

from __future__ import annotations

import os
import re
from typing import Mapping

import torch

from . import msgpack_io
from .from_jax import map_jax_tree

REL_TABLE = "attn.relative_position_bias_table"
FRAG_TABLE = "attn.fragment_position_bias_table"


def save_checkpoint(path: str, state: dict) -> None:
    """Write ``state`` atomically (to a temporary name, then renamed)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def is_msgpack(path: str) -> bool:
    """Whether the file at ``path`` is a flax msgpack file (else a
    ``torch.save`` file)."""
    with open(path, "rb") as f:
        return not msgpack_io.is_torch_file(f.read(8))


def load_checkpoint(path: str, device="cpu") -> dict:
    """A ``torch.save`` file's dict, or a JAX msgpack file's tree (numpy
    arrays under flax names)."""
    if is_msgpack(path):
        return msgpack_io.read(path)
    return torch.load(path, map_location=device, weights_only=True)


def weights_of(loaded: Mapping) -> Mapping:
    """The weights of a loaded file: under ``params`` (the port's and the
    JAX package's files), under ``state_dict`` (reference ``.pth`` files),
    or the bare dict."""
    return loaded.get("params", loaded.get("state_dict", loaded))


def strip_module_prefix(sd: Mapping) -> dict:
    """Drop DDP's ``module.`` prefix (reference trainer_ddp.py:74-77)."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def is_timm_swin2d(sd: Mapping) -> bool:
    """Whether ``sd`` is a timm 2D Swin's state dict: a 4-D patch kernel."""
    w = sd.get("patch_embed.proj.weight")
    return w is not None and len(w.shape) == 4


def timm_swin2d_state_dict(sd: Mapping, prefix: str = "") -> dict:
    """A timm Swin-T state dict as ``swin_2d_tiny``'s, under ``prefix``:
    the (C, 3, 4, 4) patch kernel gains a time axis; timm >= 0.9's
    downsample at the entry of stage ``i`` (``layers.{i}.downsample``)
    moves to the exit of stage ``i - 1``, where the original and Video-Swin
    layouts keep it; ``head.*``, ``relative_position_index`` and
    ``attn_mask`` are dropped.  The (13 x 13, heads) relative tables are
    the (1 x 13 x 13, heads) tables of a (1, 7, 7) window as they are."""
    entry_style = ("layers.0.downsample.reduction.weight" not in sd
                   and any(".downsample." in k for k in sd))
    out = {}
    for k, v in sd.items():
        if (k.startswith("head.") or k.endswith("relative_position_index")
                or k.endswith("attn_mask")):
            continue
        m = re.match(r"layers\.(\d+)\.downsample\.(.*)", k)
        if entry_style and m:
            k = f"layers.{int(m.group(1)) - 1}.downsample.{m.group(2)}"
        if k == "patch_embed.proj.weight" and len(v.shape) == 4:
            v = torch.as_tensor(v)[:, :, None]
        out[prefix + k] = v
    return out


def _swin2d_prefix(own: Mapping) -> str:
    """The prefix of the model's one 2D Swin trunk (a patch kernel of
    depth 1), or ``""``."""
    pre = [k[:-len("patch_embed.proj.weight")] for k, v in own.items()
           if k.endswith("patch_embed.proj.weight") and v.dim() == 5
           and v.shape[2] == 1]
    return pre[0] if len(pre) == 1 else ""


def fork_fragment_tables(sd: Mapping, wanted) -> dict:
    """The reference LSVQ loader's fork: each fragment-bias table in
    ``wanted`` that ``sd`` lacks is taken from its block's relative-bias
    table (a Video-Swin checkpoint has no fragment tables)."""
    out = dict(sd)
    for name in wanted:
        if name.endswith(FRAG_TABLE) and name not in out:
            rel = name[:-len(FRAG_TABLE)] + REL_TABLE
            if rel in out:
                out[name] = out[rel]
    return out


@torch.no_grad()
def merge_state_dict(model: torch.nn.Module, sd: Mapping,
                     strict: bool = False, reference: bool = True
                     ) -> dict[str, list[str]]:
    """Copy the entries of ``sd`` that match ``model``'s ``state_dict`` by
    name and shape into the model (cast to each entry's dtype, on its
    device), after stripping ``module.``, normalising a timm 2D Swin and
    forking the fragment tables when ``reference`` (a reference
    checkpoint's fixes).  Returns the report
    ``{"missing", "unexpected", "mismatched"}`` (model names ``sd`` lacks;
    names of ``sd`` the model lacks; names whose shapes differ), which
    ``strict`` turns into a ``ValueError``."""
    own = model.state_dict()
    if reference:
        sd = strip_module_prefix(sd)
        if is_timm_swin2d(sd):
            sd = timm_swin2d_state_dict(sd, _swin2d_prefix(own))
        sd = fork_fragment_tables(sd, own)
    unexpected, mismatched = [], []
    for name, value in sd.items():
        if name not in own:
            unexpected.append(name)
        elif tuple(own[name].shape) != tuple(value.shape):
            mismatched.append(name)
        else:
            own[name].copy_(torch.as_tensor(value))
    missing = [name for name in own if name not in sd]
    if strict and (missing or unexpected or mismatched):
        raise ValueError(f"strict load failed: missing={missing} "
                         f"unexpected={unexpected} mismatched={mismatched}")
    return {"missing": missing, "unexpected": unexpected,
            "mismatched": mismatched}


def merge_jax_weights(model: torch.nn.Module, params: Mapping,
                      batch_stats: Mapping | None = None
                      ) -> dict[str, list[str]]:
    """Graft JAX ``params`` / ``batch_stats`` trees (whole or partial) onto
    ``model``; the report of :func:`merge_state_dict`, with the JAX leaves
    that map to no port name among ``unexpected``."""
    sd, unread = map_jax_tree(params, batch_stats)
    report = merge_state_dict(model, sd, reference=False)
    report["unexpected"] += unread
    return report


def load_weights(model: torch.nn.Module, path: str) -> dict[str, list[str]]:
    """Merge the weights of the file at ``path`` into ``model`` and print
    the report's counts (as the JAX trainer prints them)."""
    loaded = load_checkpoint(path)
    if is_msgpack(path):
        report = merge_jax_weights(model, loaded.get("params", loaded),
                                   loaded.get("batch_stats"))
    else:
        report = merge_state_dict(model, weights_of(loaded))
    print("loaded", path, {k: len(v) for k, v in report.items()})
    return report
