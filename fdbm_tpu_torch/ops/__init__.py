"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper counts its kernel launches in a ``launches`` attribute, so a
run can show that it went through the kernels: ``grid_rnn_seq1_pair``,
``flat_group_norm`` and ``frame_attention`` (serving), ``grid_bilstm_fold``
(the training route without a gradient), and ``grid_fold_train_pair`` and
``grid_fold_train_pair_bwd`` (the training route's forward and backward).
"""

from typing import Dict

from fdbm_tpu_torch.ops.attention import flat_group_norm, frame_attention
from fdbm_tpu_torch.ops.gridrnn import grid_bilstm_fold, grid_rnn_seq1_pair
from fdbm_tpu_torch.ops.gridrnn_train import grid_fold_train_pair, grid_fold_train_pair_bwd

KERNELS = (grid_rnn_seq1_pair, flat_group_norm, frame_attention, grid_bilstm_fold,
           grid_fold_train_pair, grid_fold_train_pair_bwd)


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


__all__ = ["grid_rnn_seq1_pair", "flat_group_norm", "frame_attention", "grid_bilstm_fold",
           "grid_fold_train_pair", "grid_fold_train_pair_bwd", "launch_counts",
           "reset_launch_counts"]
