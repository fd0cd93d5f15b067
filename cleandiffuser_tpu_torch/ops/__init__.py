from .dit_block import dit_block_op, dit_block_reference, fused_dit_block, pack_dit_block_params
