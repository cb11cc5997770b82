"""The plain references of the benchmark's configurations: one file a
configuration (``<config name>.py``), built from ``plain``.  They import
PyTorch only, read the weights the harness made, and compute in f32."""
