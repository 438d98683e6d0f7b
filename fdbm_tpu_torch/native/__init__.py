"""Host-side C++ of the port, bound through ctypes: the native WAV decoder
of the data pipeline (``wavio.cc``, built by g++ at first use)."""

from fdbm_tpu_torch.native.wavio import load_crop_pair_native, wav_info

__all__ = ["load_crop_pair_native", "wav_info"]
