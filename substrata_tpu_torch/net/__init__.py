"""Replication records of substrata_tpu_torch: the snapshot rings and
physics ownership (a copy of the reference's numpy-only
``substrata_tpu/net/snapshots.py``).  The networked client and server are
not ported yet."""
