"""PyTorch port of flowtrack_tpu/eval: COCO keypoint AP, PoseTrack mAP and
MOTA, and the optical-flow metrics."""
