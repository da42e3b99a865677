"""Peer/task state machines and host types."""
