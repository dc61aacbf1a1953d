"""The stream-level encoder that drives the device block encode."""
