"""Peer models."""
from repro_torch.models.model import Model, input_specs, batch_specs
