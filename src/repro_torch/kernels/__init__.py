"""Hand-written CUDA kernels for the columnar datapath (sources in
``csrc/``), each with a plain PyTorch version beside it."""
