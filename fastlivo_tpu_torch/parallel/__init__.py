"""LiDAR-inertial multi-device: residual rows and the block-sharded map over
`torch.distributed` (port of the JAX package's parallel/)."""
