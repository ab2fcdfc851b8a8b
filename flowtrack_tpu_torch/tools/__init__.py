"""The port's command-line entry points, with the arguments of the JAX
package's ``tools/*.py``: ``python3 -m flowtrack_tpu_torch.tools.track``
(and ``test``, ``track_video``, ``demo``, ``eval_flow``, ``train``,
``train_flow``, ``export_weights``). Each that computes runs on the card
unless ``--device cpu`` is given."""
