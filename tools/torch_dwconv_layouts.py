"""conv_tiny's depthwise (k, 7, 7) Conv3d at its stage shapes (B=1, 16
frames after the stem, bf16) in three layouts on one card: the
channels_last_3d view of a (B, T, H, W, C) volume (cuDNN's path), a
contiguous NCDHW copy and back (what ``kvq_tpu_torch/nn/convnext.py:
conv_cl`` runs), and the view with cuDNN switched off.  Prints each
layout's time (CUDA events), its max |difference| to the contiguous one,
its kernel launches and kernel names (torch.profiler).

    python3 tools/torch_dwconv_layouts.py
"""
import torch, torch.nn.functional as F, time
from torch.profiler import profile, ProfilerActivity

def ms(fn, it=10):
    fn(); torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(it): fn()
    b.record(); b.synchronize()
    return a.elapsed_time(b) / it

shapes = [(16, 56, 56, 96, 3), (16, 56, 56, 96, 1), (16, 28, 28, 192, 3), (16, 14, 14, 384, 3), (16, 7, 7, 768, 3)]
for T, H, W, C, k in shapes:
    x = torch.randn(1, T, H, W, C, device="cuda").bfloat16()
    w = torch.randn(C, 1, k, 7, 7, device="cuda").bfloat16()
    b = torch.randn(C, device="cuda").bfloat16()
    pad = (k // 2, 3, 3)
    cl = lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, 1, pad, 1, C)
    nc = lambda: F.conv3d(x.permute(0, 4, 1, 2, 3).contiguous(), w, b, 1, pad, 1, C).permute(0, 2, 3, 4, 1).contiguous()
    def nocudnn():
        with torch.backends.cudnn.flags(enabled=False):
            return F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, 1, pad, 1, C)
    ref = nc().float()
    for name, fn in (("channels_last_3d view", cl), ("NCDHW contiguous + back", nc), ("cudnn off, cl view", nocudnn)):
        out = fn()
        o = out if out.shape == ref.shape else out.permute(0, 2, 3, 4, 1)
        err = (o.float() - ref).abs().max().item()
        t = ms(fn)
        with profile(activities=[ProfilerActivity.CUDA, ProfilerActivity.CPU]) as p:
            fn(); torch.cuda.synchronize()
        ks = [(e.key[:70], e.count) for e in p.key_averages() if getattr(e, "self_device_time_total", 0)]
        launches = sum(e.count for e in p.key_averages() if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx", "cudaLaunchKernelExC"))
        print(f"T{T} {H}x{W} C{C} k{k} {name}: {t:.4f} ms, max|d| {err:.3g}, launches {launches}, kernels {ks[:4]}", flush=True)
