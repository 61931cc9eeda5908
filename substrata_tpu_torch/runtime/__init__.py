"""Host-side runtime helpers of the port: the pipelined readback and the
system codec bindings (libmpg123, libopus, libmp3lame over ctypes)."""
