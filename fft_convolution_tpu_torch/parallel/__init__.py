"""Many-voice and multi-device engines — counterpart of
``fft_convolution_tpu/parallel/``: :mod:`.farm` (voice-stacked uniform
stages, streamed through the uniform engine's conv core over the voice
axis) and :mod:`.farm2` (the two-stage reverb farm whose big tail runs on
kernel B5; the short-IR farm streams through the two-stage engine's aligned
path).  The multi-device forms run one process a rank over a
``torch.distributed`` mesh (:mod:`.mesh`): the segment-sharded
frequency-delay line (:mod:`.partition`, one all-reduce a block), the
sharded two-stage engine (:mod:`.two_stage_sp`, one a tail period) and the
voice-sharded farms (each rank streams ``voice_slab`` of its
``mesh.voice_range``: no collective)."""
