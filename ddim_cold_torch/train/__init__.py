"""Training: the step (optimizer, loss, grad accumulation, EMA) and the
trainer loop."""
