"""The full CLIP: the text encoder, the ModifiedResNet visual tower, and the
joint image/text logits (counterpart of kvq_tpu/nn/clip_model.py; reference
vendored OpenAI CLIP, clip/model.py).

  - :class:`AttentionPool2d` (model.py:56-91): the mean token prepended to
    the grid, a learned position embedding, one multi-head attention whose
    only query is that mean token;
  - :class:`ModifiedResNet` (model.py:93-146): a three-conv stem, an
    avg-pool, four stages of :class:`Bottleneck` whose stride is an
    avg-pool before the expanding conv (anti-aliased), and the attention
    pool; its BatchNorm is flax's (:class:`~kvq_tpu_torch.nn.resnet.
    BatchNorm`);
  - :class:`VisionTransformer`: the port's ViT tower
    (:class:`~kvq_tpu_torch.nn.clip_vit.VisualTransformer`, no adapters)
    with ``ln_post`` and ``proj`` on the class token;
  - :class:`TextTransformer` (model.py:340-409): token and learned
    position embeddings, the pre-LN transformer under a causal mask (-inf
    above the diagonal), ``ln_final``, the token at the argmax of the ids
    (the end-of-text token, the largest id) through ``text_projection``;
  - :class:`CLIP` (model.py:299-427): ``logit_scale`` starts at ln(1/0.07)
    and is applied as ``exp``; each embedding is divided by its L2 norm
    ``+ 1e-8``, as the JAX package does.

Parameter names are OpenAI's (``visual.*``, ``token_embedding.weight``,
``positional_embedding``, ``transformer.resblocks.{i}.*``, ``ln_final``,
``text_projection``, ``logit_scale``), so an OpenAI state dict loads with
``load_state_dict`` (:func:`load_clip`).  Images are (B, H, W, 3),
CLIP-normalised; the LayerNorms are the JAX package's (eps 1e-6).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .clip_vit import Transformer, VisualTransformer
from .layers import LayerNorm
from .resnet import BatchNorm


class AttentionPool2d(nn.Module):
    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def forward(self, x):
        # x: (B, C, H, W) -> (B, output_dim)
        B, C = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding.to(x.dtype)[None]
        h, hd = self.num_heads, C // self.num_heads

        def heads(t):
            return t.reshape(B, t.shape[1], h, hd).transpose(1, 2)

        q = heads(self.q_proj(x[:, :1])) * hd ** -0.5
        k, v = heads(self.k_proj(x)), heads(self.v_proj(x))
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2))
        attn = attn.softmax(dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, C)
        return self.c_proj(out)


class Bottleneck(nn.Module):
    """CLIP's ResNet bottleneck (model.py:12-53): 1x1, 3x3, avg-pool of the
    stride, 1x1 expanding 4x; the shortcut of a stage's first block
    avg-pools, then a 1x1 conv and BatchNorm (``downsample.0``/``.1``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, 4 * planes, 1, bias=False)
        self.bn3 = BatchNorm(4 * planes)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, 4 * planes, 1, bias=False),
            BatchNorm(4 * planes)) if downsample else None)

    def _pool(self, x):
        return F.avg_pool2d(x, self.stride) if self.stride > 1 else x

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self._pool(out)))
        idn = x if self.downsample is None else self.downsample(self._pool(x))
        return F.relu(out + idn)


class ModifiedResNet(nn.Module):
    """Input (B, H, W, 3); output (B, output_dim)."""

    def __init__(self, layers=(3, 4, 6, 3), output_dim: int = 1024,
                 heads: int = 32, width: int = 64,
                 input_resolution: int = 224):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1,
                               bias=False)
        self.bn1 = BatchNorm(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1,
                               bias=False)
        self.bn2 = BatchNorm(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = BatchNorm(width)
        inplanes = width
        for stage, blocks in enumerate(layers):
            planes = width * 2 ** stage
            stride = 1 if stage == 0 else 2
            setattr(self, f"layer{stage + 1}", nn.Sequential(*(
                Bottleneck(inplanes if b == 0 else 4 * planes, planes,
                           stride if b == 0 else 1, downsample=b == 0)
                for b in range(blocks))))
            inplanes = 4 * planes
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32,
                                        heads, output_dim)

    def forward(self, x):
        x = x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = F.avg_pool2d(x, 2)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return self.attnpool(x)


class VisionTransformer(VisualTransformer):
    """The ViT tower of a plain CLIP: ``ln_post`` of the class token times
    ``proj``.  Input (B, H, W, 3); output (B, output_dim)."""

    def __init__(self, width: int, layers: int, heads: int, patch_size: int,
                 image_grid: int, output_dim: int):
        super().__init__(width, layers, heads, patch_size, image_grid)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def forward(self, x):
        cls = self.ln_post(self.tokens(x)[:, 0])
        return cls @ self.proj.to(cls.dtype)


class TextTransformer(nn.Module):
    """Input (B, L) token ids, zero-padded after the end-of-text token;
    output (B, embed_dim)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, layers: int = 12, heads: int = 8,
                 embed_dim: int = 512):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(context_length, width))
        self.transformer = Transformer(width, layers, heads)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))

    def forward(self, text):
        L = text.shape[1]
        dt = self.positional_embedding.dtype
        x = (self.token_embedding.weight.to(dt)[text]
             + self.positional_embedding[:L][None])
        causal = torch.full((L, L), -math.inf, device=x.device).triu(1)
        for blk in self.transformer.resblocks:
            x = blk(x, causal)
        x = self.ln_final(x)
        pooled = x[torch.arange(x.shape[0], device=x.device),
                   text.argmax(dim=-1)]
        return pooled @ self.text_projection.to(pooled.dtype)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    # vision: a tuple of stage depths means a ModifiedResNet
    vision_width: int = 768
    vision_layers: tuple | int = 12
    vision_patch_size: int | None = 16
    image_resolution: int = 224
    # text
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12


def clip_config_from_state_dict(sd) -> CLIPConfig:
    """The architecture of an OpenAI CLIP state dict (reference
    ``build_model``, clip/model.py:455-482)."""
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len({k.split(".")[3] for k in sd
                             if k.startswith("visual.transformer.resblocks")})
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid
    else:
        vision_layers = tuple(
            len({k.split(".")[2] for k in sd
                 if k.startswith(f"visual.layer{b}")}) for b in (1, 2, 3, 4))
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        out_width = round(
            (sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        vision_patch_size = None
        image_resolution = out_width * 32
    width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        vision_width=vision_width, vision_layers=vision_layers,
        vision_patch_size=vision_patch_size,
        image_resolution=image_resolution,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=width, transformer_heads=max(1, width // 64),
        transformer_layers=len({k.split(".")[2] for k in sd
                                if k.startswith("transformer.resblocks")}),
    )


class CLIP(TextTransformer):
    """The joint model: the text encoder's parameters at the top level, as
    OpenAI's state dict holds them, ``visual`` and ``logit_scale``.
    ``encode_image`` / ``encode_text`` return unnormalised embeddings;
    ``forward(image, text)`` returns (logits_per_image, logits_per_text)
    in float32."""

    def __init__(self, config: CLIPConfig = CLIPConfig()):
        cfg = config
        super().__init__(cfg.vocab_size, cfg.context_length,
                         cfg.transformer_width, cfg.transformer_layers,
                         cfg.transformer_heads, cfg.embed_dim)
        self.config = cfg
        if isinstance(cfg.vision_layers, (tuple, list)):
            self.visual = ModifiedResNet(
                tuple(cfg.vision_layers), cfg.embed_dim,
                cfg.vision_width // 2, cfg.vision_width,
                cfg.image_resolution)
        else:
            patch = cfg.vision_patch_size or 16
            self.visual = VisionTransformer(
                cfg.vision_width, cfg.vision_layers,
                max(1, cfg.vision_width // 64), patch,
                cfg.image_resolution // patch, cfg.embed_dim)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, image):
        return self.visual(image)

    def encode_text(self, text):
        return super().forward(text)

    def forward(self, image, text):
        img = self.encode_image(image).float()
        txt = self.encode_text(text).float()
        img = img / (img.norm(dim=-1, keepdim=True) + 1e-8)
        txt = txt / (txt.norm(dim=-1, keepdim=True) + 1e-8)
        logits = self.logit_scale.float().exp() * img @ txt.T
        return logits, logits.T


def load_clip(path: str, device="cuda") -> CLIP:
    """An OpenAI CLIP checkpoint (a state dict, or the TorchScript archive
    OpenAI ships) as a float32 :class:`CLIP` on ``device``, its
    architecture read from the state dict (reference ``clip.load``,
    clip/clip.py:86-183, without the download)."""
    from ..core.device import resolve_device

    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not a TorchScript archive
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
    sd = {k: v for k, v in sd.items()
          if k not in ("input_resolution", "context_length", "vocab_size")}
    dev = resolve_device(device)
    with torch.device(dev):
        model = CLIP(clip_config_from_state_dict(sd))
    model.load_state_dict({k: v.float() for k, v in sd.items()})
    return model.eval()
