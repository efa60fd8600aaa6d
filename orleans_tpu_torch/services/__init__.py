"""User-defined per-silo partitioned grain services (reference
src/Orleans.Runtime/Services/ + Core.Abstractions/Services/IGrainService.cs)."""

from .grain_service import GrainService, GrainServiceClient, add_grain_service

__all__ = ["GrainService", "GrainServiceClient", "add_grain_service"]
