"""PETSc's tutorial programs on the port (``python -m petsc_tpu_torch.examples.ex56``)."""
