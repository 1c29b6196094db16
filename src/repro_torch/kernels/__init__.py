"""Hand-written CUDA kernels (sources in ``csrc/``): the columnar datapath's
pack, unpack, take and bitmap expand, and the models' flash attention, each
with a plain PyTorch version beside it."""
