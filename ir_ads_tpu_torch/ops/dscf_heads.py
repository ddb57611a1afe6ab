"""Channels a DSCF head, by kernel: the widths each DSCF attention kernel is
compiled for (the ``hc`` its CUDA entry point switches on, csrc/dscf.cuh's
``kHeadWidth``), in one place.

A head has 8 channels at every Swin-B DSCF level, 12 at every Swin-L level,
and at the MiT's four stages 8, 8, 10, 8 (CMNeXt-B1..B5: 64, 128, 320, 512
x 0.25 over 2, 4, 8, 16 heads) or 4, 4, 5, 4 (CMNeXt-B0).

  dscf_rows (K4)          every width: the rows path at every Swin level
                          and, under r4, r4i8, r2, v5 and map, at every
                          MiT stage (level 3's unpacked form);
  dscf_attention (K17)    every width: dscf_pallas and dscf_pallas2 run it
                          at every level, so at every MiT stage too;
  dscf_fused (K16)        8 and 12: dscf_pallas4 runs it at levels 0-2
                          only, and a legacy model takes level 3's entry
                          (the einsum) at every stage;
  dscf_rows_bwd (K8)      8 and 12: the train dispatch backpropagates
                          through K4 at Swin's levels 0-2 only (the MiT's
                          DSCF trains on the einsum).

A width outside a kernel's list has no instance: the wrapper raises on a
CUDA tensor.  The plain versions take any width, as the JAX package's
kernels do.
"""

from __future__ import annotations

HEAD_CHANNELS = {
    "dscf_rows": (4, 5, 8, 10, 12),
    "dscf_attention": (4, 5, 8, 10, 12),
    "dscf_fused": (8, 12),
    "dscf_rows_bwd": (8, 12),
}


def head_channels(kernel: str, gc: int, hg: int) -> int:
    """The channels a head of ``kernel``'s input, gc over hg heads;
    ``ValueError`` where the kernel has no instance at that width."""
    hc = gc // hg if hg else 0
    if hg <= 0 or gc != hg * hc or hc not in HEAD_CHANNELS[kernel]:
        raise ValueError(f"{kernel}: takes {HEAD_CHANNELS[kernel]} channels per head; got "
                         f"{gc} channels over {hg} heads")
    return hc
