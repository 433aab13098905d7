"""Examples of the port, each a ``main(argv)`` that returns what it printed
and checked, runnable as ``python -m fft_convolution_tpu_torch.examples.<name>``:

* :mod:`.compare_partitioned` — uniform against two-stage on the reference
  workload (the reference's ``examples/compare_partitioned.rs``);
* :mod:`.reverb_wav` — WAV in, wet mix out, through the numpy boundary;
* :mod:`.reverb_farm` — ``ReverbFarm`` of V voices against a standalone
  engine;
* :mod:`.serve_morph` — the audio-callback shape: odd-size pushes through
  the real-time dispatcher over kernel B3, with a morph posted mid-stream;
* :mod:`.giant_ir_multichip` — one long IR served by the sharded two-stage
  engine over spawned ranks, against the single-device engine;
* :mod:`.dryrun_multichip` — every sharded form on a ``(dp, sp)`` mesh of
  spawned ranks, against the single-device engines.
"""
