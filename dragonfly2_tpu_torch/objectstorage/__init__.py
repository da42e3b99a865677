"""Object storage: backends + the daemon's S3-ish HTTP service.

Port of dragonfly2_tpu/objectstorage/__init__.py. Capability parity with
pkg/objectstorage (S3/OSS/OBS behind one interface,
objectstorage.go:206-211) and client/daemon/objectstorage (the daemon's
object-storage HTTP API backed by P2P, objectstorage.go:724). Host code:
nothing here imports torch.
"""

from dragonfly2_tpu_torch.objectstorage.backends import (
    FilesystemBackend,
    ObjectMetadata,
    new_backend,
)
from dragonfly2_tpu_torch.objectstorage.service import ObjectStorageService

__all__ = ["FilesystemBackend", "ObjectMetadata", "new_backend", "ObjectStorageService"]
