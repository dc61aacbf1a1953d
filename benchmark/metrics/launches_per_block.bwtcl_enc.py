"""Kernels launched in the traced slice over the blocks encoded there
(copies and fills not counted)."""


def read(run):
    s = run.slice
    return s.n_kernels / s.blocks if s.blocks and s.n_kernels else None
