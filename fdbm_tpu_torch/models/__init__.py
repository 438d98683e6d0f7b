"""Backbone registry and model families of the port.

Names mirror ``fdbm_tpu.models.BackboneRegistry`` so the YAML config
surface is the same. The TF-GridNet variants and their predictive twins are
ported; NCSN++ is not.
"""

from fdbm_tpu_torch.utils.registry import Registry

BackboneRegistry: Registry = Registry("Backbone")

# Populate the registry.
from fdbm_tpu_torch.models import tfgridnet as _tfgridnet  # noqa: E402,F401

__all__ = ["BackboneRegistry"]
