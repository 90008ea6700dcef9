"""FLAC host files: bit reader, frame parser and encoder."""
