// TF-GridNet RNN path on the canvas: unfold(k=4) -> BiLSTM -> deconv(k=4)
// -> overlap-add, for both directions, as three kernels.
//
// Replaces fdbm_tpu/ops/gridrnn.py:grid_rnn_seq1_pair (the Pallas
// _canvas_kernel and its _advance_and_fold core), which does the whole path
// per grid cell in VMEM. Shapes: x [B, S, P, C] with the sequence on axis 1
// and P batch-like, so each (b, p) is one independent line of S rows;
// L = S - 3 unfold windows per line; w_ih [2, 4C, 4H] tap-major rows,
// w_hh [2, H, 4H], bias [2, 4H] (gates i, f, g, o), wd [2H, 4C] tap-major
// columns. Returns the unsummed per-direction folds outf, outb [B, S, P, C]
// (no deconv bias), exact on every row; the model reads rows [3, L-1].
//
// What bounds it on the H100: the recurrence. Each of the L steps of a line
// needs the whole previous hidden state, so the 2 * 4H * H fp32 operations
// per line and step are a chain of L dependent matrix-vector products; the
// card's 67 TFLOP/s fp32 would take 0.2 ms for the recurrence of a
// production call, and the time goes instead to per-step latency (shared
// memory reads, two block barriers a step).
//
// What the design does about it (the three stages of gridrnn_core.cuh):
//   1. window_proj_kernel takes the input projection, 2/3 of the FLOPs and
//      free of the recurrence, out of the sequential loop: one tiled product
//      for all lines, steps and both directions, reading the k=4 windows
//      straight from the canvas (the unfold never exists in memory).
//   2. gridrnn_rec_kernel runs the recurrence with w_hh held in registers
//      and shared memory; the cell update keeps c in a register of the
//      thread that owns (line, unit). Next step's pre-activations are
//      fetched while this step's products run.
//   3. fold_kernel computes the deconv projection as a tiled product over
//      the hidden states and does the 4-tap overlap-add from shared memory,
//      writing each output row once, in canvas layout.
// The hidden states cross device memory once (2 x lines x L x H floats),
// and so do the pre-activations (2 x lines x L x 4H floats) that the TPU
// kernel recomputes per step in VMEM.
#include "gridrnn_core.cuh"

extern "C" {

// Scratch the caller allocates: xp [2, B*P, L, 4H] and hs [2, B*P, L, H],
// L = S - 3. Requires 1 <= H <= 128, C % 8 == 0, C <= 64, all pointers
// fp32, contiguous, on the stream's device.
int gridrnn_seq1_pair(const float* x, const float* w_ih, const float* w_hh, const float* bias,
                      const float* wd, float* xp, float* hs, float* outf, float* outb, int B,
                      int S, int P, int C, int H, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!shape_ok(S, C, H)) return cudaErrorInvalidValue;
  const int L = S - (KS - 1);
  const int N = 4 * H;
  cudaError_t err = launch_window_proj<false>(x, x, w_ih, (long long)KS * C * N, N, 1, bias, xp,
                                              B, S, P, C, N, stream);
  if (err != cudaSuccess) return err;
  err = launch_rec<false>(xp, w_hh, hs, nullptr, B * P, L, H, stream);
  if (err != cudaSuccess) return err;
  return launch_fold<false, false>(hs, H, wd, (long long)H * KS * C, KS * C, 1, outf, outb, B, S,
                                   P, C, stream);
}

}  // extern "C"
