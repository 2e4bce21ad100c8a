"""The benchmark of the PyTorch and CUDA port (``tpu_cfd_torch``) on one
NVIDIA H100: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See ``benchmark/README.md``."""
