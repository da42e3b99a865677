"""Object storage: the filesystem backend (objectstorage/backends.py)."""
