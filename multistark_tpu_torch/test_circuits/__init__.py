from .u32_add import ByteTableAir, U32AddAir, u32_add_system_inputs, u32_add_witness  # noqa: F401
