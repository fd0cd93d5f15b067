from .integrate import device_of, place_pipeline, setup_mesh
