"""PyTorch/CUDA port of the R-GCN link-prediction framework.

The JAX package ``relationprediction_tpu`` is the reference this package is
held against; this one imports neither it nor JAX. Submodules are imported
explicitly (``relationprediction_torch.models.build`` and so on), so
importing the package itself loads nothing.
"""

__version__ = "0.1.0"
