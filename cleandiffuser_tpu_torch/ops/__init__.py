from .dit_block import dit_block_op, dit_block_reference, fused_dit_block, pack_dit_block_params
from .film_resblock import film_resblock_op, film_resblock_reference, fused_film_resblock
from .solver_update import fused_solver_update, solver_update_op, solver_update_reference
