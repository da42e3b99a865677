"""The peer daemon and its CLIs: the data plane.

Port of dragonfly2_tpu/client: piece storage, the back-to-source clients,
the upload server, the peer-task conductor, the daemon, the proxy and
dfget/dfcache/dfstore. Host code only: nothing here imports torch, so a
machine can run many daemons without a device context in any of them.
"""
