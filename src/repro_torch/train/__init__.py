"""Training: the AdamW optimizer (fp32 or int8 moments) and the train
step with its chunked cross-entropy."""
