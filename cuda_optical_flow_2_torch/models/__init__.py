"""Flow pipelines: pyramidal Lucas-Kanade, its streaming loop, Horn-Schunck."""
