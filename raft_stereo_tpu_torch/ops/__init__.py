"""Tensor operations of the port: plain torch ops, plus the refinement
loop's kernel wrappers in :mod:`.stream`."""
