"""AAC host files: tables, ADTS bitstream and the SBR host chain."""
