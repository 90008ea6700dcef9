"""CELT (Opus) host files: mode, range decoder, allocation, PVQ, entropy
layer and packet framing."""
