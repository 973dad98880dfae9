"""The port of the JAX package's ``experiments/exp1-5``, one module each, run
as ``python -m fenicsxfus_tpu_torch.experiments.<name>``. They run in fp64
on every device, as the JAX scripts force x64."""
