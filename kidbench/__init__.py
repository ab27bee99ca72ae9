"""kidbench: the benchmark of the PyTorch and CUDA port,
``kid_tpu_torch``.  Run ``python -m kidbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the checkout's root; see README.md."""
