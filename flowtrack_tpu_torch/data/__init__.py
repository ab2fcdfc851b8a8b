"""PyTorch port of flowtrack_tpu/data: image loading, the COCO pose and the
flow-pair datasets, and the batch loader that feeds the train steps."""
