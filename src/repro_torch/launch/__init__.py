"""Entry points of the port (``python -m repro_torch.launch.<name>``, or
``torchrun --nproc-per-node N -m repro_torch.launch.<name>`` sharded) and
the meshes they build (:mod:`.mesh`)."""
