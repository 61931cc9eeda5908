"""Networking and replication of substrata_tpu_torch: copies of the
reference's numpy-only ``substrata_tpu/net`` modules — the wire protocol,
TLS, time sync, the snapshot rings and physics ownership, the game client
and the game server.  The server and client are host code; only a
client's ``ClientApp`` and the server's texture pipeline touch the card."""
