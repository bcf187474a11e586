"""CSR row blocks, the libsvm and libfm parsers and bucket padding."""
