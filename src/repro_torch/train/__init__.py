"""Training of the port: AdamW, the train and serve steps, the training
loop, checkpoint/restore and the fault-tolerance substrate."""
