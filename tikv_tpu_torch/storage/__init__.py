"""The Percolator record formats (``txn_types``) and the MVCC reader
(``mvcc``) the columnar cache's interpreted build reads through."""
