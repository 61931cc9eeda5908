"""Host-side runtime helpers of the port (the pipelined readback)."""
