"""File scans (`spark_rapids_tpu/io/`): the parquet scan with its device
decode, the footer side of the file-scan plan node, and dynamic pruning."""
