"""Dense matching row-tiled over the cards there are, with halo rows
exchanged between neighbouring ranks (no reference equivalent: the
reference's only parallelism is a CPU thread pool).

Usage, one process a card:

    torchrun --nproc-per-node N 201_multichip_tiled_matching.py [--device DEV]

Started with plain ``python`` it runs as an explicit world of one process.
``--device cpu`` runs gloo processes on the CPU instead of NCCL ranks on
the cards.
"""

import os

import torch.distributed as dist

from simplestereo_tpu_torch import parallel
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg
from simplestereo_tpu_torch.imgio import imread

DEVICE = device_arg()
RES = REFERENCE_RES + "/tsukuba/"
img1 = imread(RES + "tsukuba_l.png")
img2 = imread(RES + "tsukuba_r.png")

if "WORLD_SIZE" in os.environ:
    rank, n = parallel.init_distributed(DEVICE)
else:
    rank, n = parallel.init_distributed(DEVICE, world_size=1, rank=0)
mesh = parallel.make_mesh({"rows": n}, device_type=DEVICE)
H = img1.shape[0] - img1.shape[0] % n
disp = parallel.tiled_asw_disparity(
    img1[:H], img2[:H], mesh, win_size=35, min_disp=4, max_disp=14,
    gamma_c=15, gamma_p=17.5, consistent=True)
if rank == 0:
    print("Tiled disparity:", tuple(disp.shape))

# The whole matcher family tiles over the mesh.
disp_sgm = parallel.tiled_sgm_disparity(
    img1[:H], img2[:H], mesh, num_disp=16, cost_method="census",
    census_window=7, P1=120, P2=480, uniqueness=0)
if rank == 0:
    print("Tiled SGM disparity:", tuple(disp_sgm.shape))

disp_gsw = parallel.tiled_gsw_disparity(
    img1[:H], img2[:H], mesh, win_size=11, max_disp=14, min_disp=4,
    gamma=12.5, f_max=20.0, consistent=True)
if rank == 0:
    print("Tiled GSW disparity:", tuple(disp_gsw.shape))
dist.destroy_process_group()
