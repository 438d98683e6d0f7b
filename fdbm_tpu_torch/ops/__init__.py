"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper counts its kernel launches in a ``launches`` attribute, so a
run can show that it went through the kernels: ``grid_rnn_seq1_pair``,
``flat_group_norm`` (also the launches of ``flat_group_norms``, one an
attention call) and ``frame_attention`` (serving), ``grid_bilstm_fold``
(the training route without a gradient), and ``grid_fold_train_pair`` and
``grid_fold_train_pair_bwd`` (the training route's forward and backward);
outside the fused grid kernels' gate, ``bilstm_fused_forward`` (serving),
``lstm_core`` and ``lstm_core_bwd`` (training) and ``lstm_forward`` (the
training route without a gradient). The serving kernels' bf16 forms
(``inference_dtype: bfloat16``) count apart, in ``launches_bf16``, listed
as ``<name>_bf16``.
"""

from typing import Dict

from fdbm_tpu_torch.ops.attention import flat_group_norm, frame_attention
from fdbm_tpu_torch.ops.gridrnn import grid_bilstm_fold, grid_rnn_seq1_pair
from fdbm_tpu_torch.ops.gridrnn_train import grid_fold_train_pair, grid_fold_train_pair_bwd
from fdbm_tpu_torch.ops.lstm import bilstm_fused_forward, lstm_core, lstm_core_bwd, lstm_forward

KERNELS = (grid_rnn_seq1_pair, flat_group_norm, frame_attention, grid_bilstm_fold,
           grid_fold_train_pair, grid_fold_train_pair_bwd, bilstm_fused_forward, lstm_core,
           lstm_core_bwd, lstm_forward)
# The kernels with a bf16 form: the serving kernels 1, 2, 3 and 7.
BF16_KERNELS = (grid_rnn_seq1_pair, flat_group_norm, frame_attention, bilstm_fused_forward)


def launch_counts() -> Dict[str, int]:
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    counts.update({f"{fn.__name__}_bf16": fn.launches_bf16 for fn in BF16_KERNELS})
    return counts


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in BF16_KERNELS:
        fn.launches_bf16 = 0


__all__ = ["grid_rnn_seq1_pair", "flat_group_norm", "frame_attention", "grid_bilstm_fold",
           "grid_fold_train_pair", "grid_fold_train_pair_bwd", "bilstm_fused_forward",
           "lstm_core", "lstm_core_bwd", "lstm_forward", "launch_counts", "reset_launch_counts"]
