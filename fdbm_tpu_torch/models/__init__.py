"""Backbone registry and model families of the port.

Names mirror ``fdbm_tpu.models.BackboneRegistry`` so the YAML config
surface is the same: the TF-GridNet variants, the NCSN++ variants, and the
predictive twins of both.
"""

from fdbm_tpu_torch.utils.registry import Registry

BackboneRegistry: Registry = Registry("Backbone")

# Populate the registry.
from fdbm_tpu_torch.models import tfgridnet as _tfgridnet  # noqa: E402,F401
from fdbm_tpu_torch.models import ncsnpp as _ncsnpp  # noqa: E402,F401

__all__ = ["BackboneRegistry"]
