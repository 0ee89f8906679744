"""Data of the port: the Shanghai radar clips and the batch loader."""
