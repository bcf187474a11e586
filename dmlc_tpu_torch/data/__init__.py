"""CSR row blocks, the libsvm parser and bucket padding."""
