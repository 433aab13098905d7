"""Many-voice engines — counterpart of ``fft_convolution_tpu/parallel/``:
:mod:`.farm` (voice-stacked uniform stages, streamed through the uniform
engine's conv core over the voice axis) and :mod:`.farm2` (the two-stage
reverb farm whose big tail runs on kernel B5; the short-IR farm streams
through the two-stage engine's aligned path).  The multi-device forms
(``partition.py``, ``two_stage_sp.py``, the farm mesh) are not ported yet
(ROADMAP A11)."""
