"""Server-side application services: accounts, sessions, auctions, orders,
asset pipeline threads, server scripting glue.

Parity with the reference server layer beyond the core loop
(server/User.*, UserWebSession.*, APIKey.*, PasswordReset.*,
ParcelAuction.*, Order.*, MeshLODGenThread.*, ServerSideScripting.*).

A copy of ``substrata_tpu/server_side/__init__.py`` with the port's imports: importing
any module of the reference package loads jax, so the port keeps its own.
"""
