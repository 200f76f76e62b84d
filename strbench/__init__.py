"""strbench: the benchmark of hipstr_tpu_torch, the PyTorch and CUDA port
(`python3 -m strbench.run`; BENCHMARK.json at the checkout's root)."""
