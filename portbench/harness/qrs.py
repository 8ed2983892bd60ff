"""Records the program's QRS picks, so that the reference can follow them.

:class:`QRSRecorder` wraps ``kvq_tpu_torch.nn.regionnet.RegionSelector
.select`` (the one call a KSVQE forward makes to pick its regions) and
keeps, per call, its cls-attention input and its pick (region indices
(B, T) at eval, the (B, T, regions) indicator in training), both as they
lie on the device: no host sync is added.  ``remove()`` restores the
method.
"""

from __future__ import annotations


class QRSRecorder:
    def __init__(self):
        from kvq_tpu_torch.nn import regionnet

        self.cls = regionnet.RegionSelector
        self.orig = self.cls.select
        self.records: list = []
        orig, records = self.orig, self.records

        def select(sel, cls_attn, group_id, grid_hw, train=False, gen=None):
            out = orig(sel, cls_attn, group_id, grid_hw, train, gen)
            records.append((cls_attn.detach(), out.detach()))
            return out

        self.cls.select = select

    def remove(self):
        self.cls.select = self.orig
