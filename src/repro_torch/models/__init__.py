"""Models the port serves: the dense GQA transformer (glm4-9b) through the
``flash_decode`` kernel, and DLRM (rm2) through the ``bag_sum`` kernel."""
