"""The benchmark of ``zerocaf_tpu_torch``, the PyTorch and CUDA port, on
NVIDIA H100 cards: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  ``BENCHMARK.json`` at the repository's root
lists the cells; PERF.md says why each exists."""
