"""Learners over padded CSR batches."""
