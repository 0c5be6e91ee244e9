"""PyTorch/CUDA port of the EEG↔audio topological-analysis pipeline.

The JAX package `tda_eeg_audio_tpu` is the reference; this package mirrors
its layout (`config`, `io/`, `ops/`, `models/`) and holds its own copies of
everything it needs — it imports neither JAX nor the reference package.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
