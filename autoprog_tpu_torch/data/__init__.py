"""Device-side data pieces of the port (the host pipeline is autoprog_tpu.data)."""
