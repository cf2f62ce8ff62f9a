"""Serving example on the port: batched prefill + decode with the TTL-driven
KV tier -- shared system prompts hit the prefix cache; the adaptive TTL
decides how long blocks stay resident.  Attention runs on the flash
kernels of ``--device`` (default ``cuda``).

    PYTHONPATH=src python examples/torch_serve_decode.py --arch llama3.2-1b
    PYTHONPATH=src python examples/torch_serve_decode.py --device cpu
"""

import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main(sys.argv[1:] or ["--arch", "llama3.2-1b", "--requests", "6"])
