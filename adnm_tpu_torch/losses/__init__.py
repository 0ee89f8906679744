"""Rainfall losses of the port."""
