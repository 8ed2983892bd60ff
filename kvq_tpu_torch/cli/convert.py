"""Convert a reference torch checkpoint into the port's weights file
(counterpart of kvq_tpu/cli/convert.py)::

    python -m kvq_tpu_torch.cli.convert --kind ksvqe \
        --src KSVQE_techniqual_pretrainonLSVQ.pth --out ksvqe_lsvq.pt

The port keeps the reference's parameter names, so a conversion does what
kvq_tpu's converter does besides its layout changes: it unwraps the file
(``state_dict``, ``model_state``, ``model`` or ``network``), strips DDP's
``module.`` prefix, keeps the tensors of the kind's module, forks each
missing fragment-bias table of a Video-Swin trunk's stages 0-2 from its
block's relative table (swin_backbone.py:945-952), and normalises a timm
Swin-T state dict for ``swin_2d_tiny``.  It writes ``{"params":
state_dict}`` with ``torch.save``, the file ``load_path`` /
``test_load_path`` read (core/checkpoint.py).  The names are the module's
own: a full-model kind (``ksvqe``, ``simplevqa``) loads as ``load_path``;
the others load into their module (``merge_state_dict``).

Kinds:
  ksvqe       full VQA_Network KSVQE checkpoint (KSVQE_backbone.* [+ head])
  simplevqa   full VQA_Network SimpleVQA checkpoint (ResNet-50 + MLP head)
  swin        (LSVQ-pretrained) Video-Swin trunk
  swin2d      timm swin_tiny_patch4_window7_224 (for swin_2d_tiny)
  contrique   CONTRIQUE_checkpoint25.tar (ResNet-50 encoder + projector)
  clip        OpenAI CLIP visual tower (ViT)
  clip_full   full OpenAI CLIP (visual + text encoders)
  resnet50    torchvision/ImageNet ResNet-50 (SimpleVQA spatial branch)
  slowfast    pytorchvideo slowfast_r50 (motion-feature extractor)

``--fetch`` (kvq_tpu's download of a named pretrained file,
kvq_tpu/core/weights.py) is not ported: pass the file with ``--src``.
"""

from __future__ import annotations

import argparse
import re

import torch

from ..core.checkpoint import (
    FRAG_TABLE,
    REL_TABLE,
    save_checkpoint,
    strip_module_prefix,
    timm_swin2d_state_dict,
)

KINDS = ("ksvqe", "simplevqa", "swin", "swin2d", "contrique", "clip",
         "clip_full", "resnet50", "slowfast")

# the tensors each kind keeps, by name; ``None``: all of them
_KEEP = {
    "ksvqe": r"KSVQE_(backbone|head)\.",
    "simplevqa": r"simpleVQA_backbone\.(conv1|bn1|layer\d)\."
                 r"|simpleVQA_head\.",
    "swin": r"(patch_embed|layers|norm)\.",
    "swin2d": None,
    "contrique": r"encoder\.[014567]\.|projector\.[0134]\.",
    "clip": r"visual\.(conv1|class_embedding|positional_embedding|ln_pre"
            r"|transformer\.resblocks)",
    "clip_full": None,
    "resnet50": r"(conv1|bn1|layer\d)\.",
    "slowfast": r"blocks\.[0-4]\.",
}
# the Video-Swin trunk of a kind, whose stages 0-2 carry fragment tables
_TRUNK = {"ksvqe": "KSVQE_backbone.", "swin": ""}


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A torch checkpoint's tensors, unwrapped and without ``module.``.
    The reference's files hold pickled objects beside their tensors, so
    the file is unpickled in full: convert only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model_state", "model", "network"):
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
            break
    return strip_module_prefix({k: v for k, v in obj.items()
                                if isinstance(v, torch.Tensor)})


def fork_stage_tables(sd: dict, prefix: str) -> dict:
    """Each block of stages 0-2 of the trunk under ``prefix`` gets its
    relative table as its fragment table where it has none."""
    out = dict(sd)
    pat = re.compile(re.escape(prefix) + r"layers\.[012]\.blocks\.\d+\.")
    for name, rel in sd.items():
        if name.endswith(REL_TABLE) and pat.match(name):
            out.setdefault(name[:-len(REL_TABLE)] + FRAG_TABLE, rel)
    return out


def convert(kind: str, src: str, clip_layers: int = 12) -> dict:
    """The port's state dict of the kind's module from the file ``src``."""
    sd = load_torch_state_dict(src)
    if kind == "swin2d":
        sd = timm_swin2d_state_dict(sd)
    if _KEEP[kind] is not None:
        sd = {k: v for k, v in sd.items() if re.match(_KEEP[kind], k)}
    if kind in _TRUNK:
        sd = fork_stage_tables(sd, _TRUNK[kind])
    if kind in ("clip", "ksvqe"):
        pre = "KSVQE_backbone.CLIP_tool." if kind == "ksvqe" else ""
        if f"{pre}visual.transformer.resblocks.{clip_layers}.ln_1.weight" \
                in sd:
            raise ValueError(
                f"checkpoint has more than {clip_layers} visual resblocks "
                f"(deeper CLIP variant?): pass the tower's depth with "
                f"--clip_layers")
    return sd


def parse_args(argv=None):
    p = argparse.ArgumentParser("kvq_tpu_torch convert")
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("--src", help="torch checkpoint path")
    p.add_argument("--fetch", metavar="NAME",
                   help="not ported (kvq_tpu downloads the named file); "
                        "pass --src")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--clip_layers", type=int, default=12)
    args = p.parse_args(argv)
    if args.fetch:
        p.error("--fetch downloads weights, which the port does not do; "
                "pass the file with --src")
    if not args.src:
        p.error("--src is required")
    return args


def main(argv=None):
    args = parse_args(argv)
    sd = convert(args.kind, args.src, clip_layers=args.clip_layers)
    save_checkpoint(args.out, {"params": sd})
    print(f"wrote {args.out}: {len(sd)} tensors")


if __name__ == "__main__":
    main()
