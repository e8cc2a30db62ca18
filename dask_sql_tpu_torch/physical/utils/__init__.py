"""Helpers of the file-backed scans: parquet footers and filter pushdown."""
