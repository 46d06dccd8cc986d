"""Signal ops, the LSTM dispatch and the CUDA kernel wrappers."""
