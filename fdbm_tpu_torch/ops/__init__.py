"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper (``grid_rnn_seq1_pair``, ``flat_group_norm``,
``frame_attention``) counts its kernel launches in a ``launches`` attribute,
so a run can show that it went through the kernels.
"""

from typing import Dict

from fdbm_tpu_torch.ops.attention import flat_group_norm, frame_attention
from fdbm_tpu_torch.ops.gridrnn import grid_rnn_seq1_pair

KERNELS = (grid_rnn_seq1_pair, flat_group_norm, frame_attention)


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = ["grid_rnn_seq1_pair", "flat_group_norm", "frame_attention",
           "launch_counts", "reset_launch_counts"]
