# Trainer utilities of the port: config parsing, logging, the TrainSpec
# registry, the optimizer schedule and metrics.
