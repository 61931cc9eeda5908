"""Records shared by client and server (copies of the reference's numpy-only
``substrata_tpu/shared`` modules that the client's frame needs)."""
