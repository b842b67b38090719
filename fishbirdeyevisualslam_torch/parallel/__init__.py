"""Multi-device solvers over ``torch.distributed``: the landmark-sharded
global bundle adjustment and the data-parallel batched pose optimisation
(``sharded_ba``)."""
