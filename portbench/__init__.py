"""The benchmark of ``fft_convolution_tpu_torch`` on one NVIDIA H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON line (see
``README.md``).  Everything is found by name: configurations in
``configs/``, traffic mixes in ``traffic/``, engines in ``engines/``,
end-to-end metrics in ``end_to_end/``, per-layer readers in ``metrics/``
and each cell's limits in ``limits/``.  Nothing here imports ``jax`` or the
JAX package; the float64 reference (``reference/``) imports nothing of the
port either.
"""
