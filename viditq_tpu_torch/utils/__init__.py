"""Plan loading and the JAX-to-port weight bridge."""
