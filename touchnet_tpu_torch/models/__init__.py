# Model families of the port. Unlike touchnet_tpu/models/__init__.py this
# registers nothing on import: the serving slice needs no TrainSpec registry.
