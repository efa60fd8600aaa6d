"""Cluster management + control surface (reference L13,
src/Orleans.Runtime/Core/ManagementGrain.cs, Silo/SiloControl.cs,
src/OrleansManager/)."""

from .control import SiloControl, add_management
from .grain import ManagementGrain
from .load_publisher import DeploymentLoadPublisher

__all__ = ["ManagementGrain", "SiloControl", "DeploymentLoadPublisher",
           "add_management"]
