from .integrate import setup_mesh
