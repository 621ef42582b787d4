"""JPEG codec of the torch port."""
