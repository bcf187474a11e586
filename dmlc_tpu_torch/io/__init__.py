"""Local-file streams, the VFS registry and sharded input splits."""
