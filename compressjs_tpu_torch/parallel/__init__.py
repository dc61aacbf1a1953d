"""The stream-level encoders and decoders: one card (``pipeline``,
``decode``), host workers beside the card (``hetero``) and data
parallelism over blocks with ``torch.distributed`` (``mesh``)."""
