"""CSR row blocks, the parsers, row iterators and bucket padding.

Counterpart of ``dmlc_tpu/data/__init__.py``, with its exports. Importing
the package root (``import dmlc_tpu_torch``) registers the built-in
parsers.
"""

from dmlc_tpu_torch.data.rowblock import RowBlock, Row, RowBlockContainer
from dmlc_tpu_torch.data.parser import Parser, DataIter
from dmlc_tpu_torch.data.row_iter import RowBlockIter

__all__ = ["RowBlock", "Row", "RowBlockContainer", "Parser", "DataIter",
           "RowBlockIter"]
