"""Language-model training on one device: the optimizer
(``train/optimizer.py``), the loss and train step (``train/train_step.py``)
and the fault-tolerant training loop (``train/trainer.py``)."""
