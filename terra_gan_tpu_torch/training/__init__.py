"""Training of the port: state, the fused G+D step, .pth checkpoints and the epoch loop."""
