"""Framework-free utilities."""
