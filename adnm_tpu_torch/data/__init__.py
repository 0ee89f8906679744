"""Data of the port: the Shanghai and LAPS radar clips, the native decode
and the batch loader."""
