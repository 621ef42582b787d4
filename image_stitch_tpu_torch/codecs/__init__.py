"""Codecs of the torch port."""
