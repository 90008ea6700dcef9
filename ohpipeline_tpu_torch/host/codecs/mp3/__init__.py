"""MP3 (Layer III) host files: tables, bitstream parse, encoder and the numpy
host prep of the filterbank's input (``prep``)."""
