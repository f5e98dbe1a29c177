"""Host utilities of the port: numpy helpers and JAX weight import."""
